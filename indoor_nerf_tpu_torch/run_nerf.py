"""CLI entry point of the port, the twin of the root ``run_nerf.py``:

    python -m indoor_nerf_tpu_torch.run_nerf --config configs/lego_tpu.txt \
        --datadir DIR [--flag value ...]
    python -m indoor_nerf_tpu_torch.run_nerf --config configs/lego.txt \
        --datadir DIR [--flag value ...]

It takes the JAX package's flags and config files (``train/config.py``, the
port's copy of that parser) plus ``--device`` (``cuda``, the default;
``cuda:N``; ``cpu``), and runs ``train/trainer.py::train``: training with
its test sets, videos and checkpoints, or ``--render_only``. The ``_tpu``
files run the block-hash grid; the others the parity path (the hash grid
and the hierarchical fine pass).
"""

from indoor_nerf_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
