"""The committed orbax fixture (``tests/golden/torch_orbax/``) and its
regeneration.

The card's host has neither JAX nor orbax, so what ``chip_smoke.py`` (phase
19) and the CPU tests read there is committed: a narrow CnnAvgPooling
(``SMALL``) train state of ``sed_tpu`` after ``STEPS`` float32 steps at
batch ``BATCH``, saved by ``sed_tpu``'s ``save_checkpoint`` with both
backends: ``iteration_2.ckpt.orbax`` (orbax, OCDBT + zarr, zstd) and its
msgpack twin ``iteration_2.ckpt``.  Regenerate with JAX on the CPU:

    python tests/torch_orbax_fixture.py [out_dir]

(the default ``out_dir`` is the golden directory).  orbax names its data
files by random hashes and stamps the save's time, so a regenerated fixture
holds the same arrays in different bytes.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from pathlib import Path

GOLDEN = Path(__file__).resolve().parent / "golden" / "torch_orbax"
SMALL = ((8, 2), (16, 2))
STEPS, BATCH, LR = 2, 8, 1e-3
ORBAX_NAME = f"iteration_{STEPS}.ckpt.orbax"
CKPT_NAME = f"iteration_{STEPS}.ckpt"


def sed_tpu_state(model_config=SMALL, steps=STEPS, seed=0):
    """``sed_tpu``'s CnnAvgPooling(1, ``model_config``) state after
    ``steps`` float32 steps on seeded features."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sed_tpu.configs import SpectrogramConfig
    from sed_tpu.data import device_pipeline as pipe
    from sed_tpu.models.cnn import CnnAvgPooling
    from sed_tpu.train.optim import make_optimizer
    from sed_tpu.train.state import init_state

    cfg = SpectrogramConfig()
    crop, mel = cfg.train_crop_size, cfg.mel_bins
    model = CnnAvgPooling(classes_num=1, model_config=model_config)
    state = init_state(model, jax.random.key(seed), jnp.zeros((BATCH, crop, mel, 1)),
                       make_optimizer(LR))
    rng = np.random.default_rng(seed)
    total = 4 * crop
    bufs = pipe.SpectrogramBuffers(
        features=jnp.asarray(rng.standard_normal((1, total, mel)).astype(np.float32)),
        events=jnp.asarray((rng.random((total, 1)) > 0.7).astype(np.float32)),
        start_indices=jnp.arange(total - crop, dtype=jnp.int32),
        mean=jnp.zeros((mel,)), std=jnp.ones((mel,)))
    step = pipe.make_spectrogram_train_step(model, make_optimizer(LR), cfg, 5.0, "logMel",
                                            False)
    for _ in range(steps):
        starts = jnp.asarray(rng.integers(0, total - crop, size=BATCH).astype(np.int32))
        state, _ = step(state, bufs, starts, jax.random.key(1))
    return state


def write_pair(state, out_dir, iteration=STEPS):
    """``sed_tpu``'s orbax and msgpack saves of ``state`` in ``out_dir``:
    (orbax directory, .ckpt file)."""
    from sed_tpu.train.checkpoint import save_checkpoint

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        orbax = save_checkpoint(state, tmp, iteration, backend="orbax")
        ckpt = save_checkpoint(state, tmp, iteration)
        paths = []
        for src in (orbax, ckpt):
            dst = out_dir / os.path.basename(src)
            if dst.is_dir():
                shutil.rmtree(dst)
            elif dst.exists():
                dst.unlink()
            shutil.move(src, dst)
            paths.append(dst)
    return tuple(paths)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, str(GOLDEN.parents[2]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = Path(argv[0]) if argv else GOLDEN
    orbax, ckpt = write_pair(sed_tpu_state(), out)
    size = sum(p.stat().st_size for p in orbax.rglob("*") if p.is_file()) + ckpt.stat().st_size
    print(f"wrote {orbax} and {ckpt} ({size} bytes)")


if __name__ == "__main__":
    main()
