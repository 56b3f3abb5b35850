"""Write the JAX package's β training run and the dataset shards' `meta` as
golden files for the port.

    python tests/golden/make_train_beta.py [beta] [meta]

Runs on the CPU with the JAX package (float32, x64 off) and writes beside
this script (both targets when none is named):

* `beta`: `train_beta_jax.npz` — the JAX trainer (`polar_code_tpu.train.
  train_beta.main`) on the committed shard `data/train_M8_snr5_seed0_part0.
  npz` for 2 epochs at its default flags (lr 1e-4, batch 128, λ 0.25, seed
  0, val_frac 0.1).  It holds the shard's inputs (`x` f32 [2893, 64], `y`
  int32, its `meta`), the trainer's initial parameters (`init_off_diag`:
  `SymmetricBeta.init(jax.random.key(0))` with the diagonal clamped, as the
  trainer draws them), the CSV log (`csv`, and its numbers in `rows`), the
  saved β (`beta`) and the flags (`args`, JSON).  A few seconds.
* `meta`: `dataset_meta.json` — the `meta` of every committed `data/*.npz`
  shard, by file name.  `chip_smoke.py` holds the shards it generates on
  the card to these rates; the card's copy of the repository has no `data/`.

`tests/test_torch_train.py` pins both to the committed files and holds the
port's trainer to the first on the CPU; `chip_smoke.py` does so on the card.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["POLAR_CODE_TPU_NO_CACHE"] = "1"
HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from polar_code_tpu.dlscl.beta import SymmetricBeta  # noqa: E402
from polar_code_tpu.train import train_beta  # noqa: E402

SHARD = REPO / "data" / "train_M8_snr5_seed0_part0.npz"
BETA_OUT = HERE / "train_beta_jax.npz"
META_OUT = HERE / "dataset_meta.json"
ARGS = {"M": 8, "epochs": 2, "lr": 1e-4, "batch": 128, "lambda_l2": 0.25, "seed": 0,
        "val_frac": 0.1}


def write_beta():
    with np.load(SHARD) as f:
        x, y, meta = f["abs_l0"], f["flip_idx"], str(f["meta"])
    init = SymmetricBeta.clamp_diagonal(SymmetricBeta(x.shape[1]).init(jax.random.key(ARGS["seed"])))
    with tempfile.TemporaryDirectory() as tmp:
        train_beta.main([
            "--M", str(ARGS["M"]), "--data", str(SHARD), "--epochs", str(ARGS["epochs"]),
            "--lr", str(ARGS["lr"]), "--batch", str(ARGS["batch"]),
            "--lambda_l2", str(ARGS["lambda_l2"]), "--seed", str(ARGS["seed"]),
            "--val_frac", str(ARGS["val_frac"]),
            "--checkpoint_dir", f"{tmp}/ckpt", "--log_dir", f"{tmp}/logs",
        ])
        csv_text = Path(f"{tmp}/logs/train_M{ARGS['M']}.csv").read_text()
        beta = np.load(f"{tmp}/ckpt/beta_M{ARGS['M']}.npy")
    rows = np.array([[float(v) for v in line.split(",")] for line in csv_text.splitlines()[1:]])
    np.savez_compressed(
        BETA_OUT, x=x.astype(np.float32), y=y.astype(np.int32), shard_meta=meta,
        init_off_diag=np.asarray(init["off_diag"], np.float32), csv=csv_text, rows=rows,
        beta=beta.astype(np.float32), args=json.dumps(ARGS),
    )
    print(f"wrote {BETA_OUT} ({BETA_OUT.stat().st_size} bytes)")


def write_meta():
    metas = {}
    for path in sorted((REPO / "data").glob("*.npz")):
        with np.load(path) as f:
            metas[path.name] = json.loads(str(f["meta"]))
    META_OUT.write_text(json.dumps(metas, indent=1) + "\n")
    print(f"wrote {META_OUT} ({len(metas)} shards)")


if __name__ == "__main__":
    targets = sys.argv[1:] or ["beta", "meta"]
    if "beta" in targets:
        write_beta()
    if "meta" in targets:
        write_meta()
