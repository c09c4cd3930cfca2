"""indoor_nerf_tpu_torch — the PyTorch and CUDA port of indoor_nerf_tpu.

The JAX package ``indoor_nerf_tpu`` is the reference; this package computes
the same functions on the same layouts (the ``[L*R, F*lpf]`` block table,
MLP weights stored ``[in, out]``, ``(point, level)`` rows with the level
index varying fastest), so its tests compare like with like. It imports
``torch`` and never ``jax``.

The slices ported so far:

- the parity path (what the parser's defaults and the shipped configs
  without ``_tpu`` run): the multiresolution hash grid (``--i_embed 1``,
  ``ops/encoding.py``, ``ops/hashing.py``, its TV loss ``ops/tv.py``), PE
  and the classic NeRF MLP (``--i_embed 0``, ``models/mlp.py::NeRFBig``)
  and the hierarchical fine pass (``render/renderer.py``), in training,
  evaluation, online and baked serving; plain PyTorch, as the JAX package
  computes it in XLA outside any Pallas kernel;
- the structural priors (``losses/priors.py``: the Manhattan frame, the
  floor and wall masks, the Manhattan, planarity and consistency losses,
  with NeRFSmall's normal net and the composited normal map) and the
  step's small extensions (``losses/distortion.py``, the table decay, the
  params EMA, the level and view anneals), which the two
  ``configs/norcliffe_common_room*.txt`` files train with; plain PyTorch,
  as the JAX package computes them in XLA;
- training from files (``run_nerf.py``, ``train/trainer.py``): the
  shipped ``configs/*_tpu.txt`` scenes through the file loaders
  (``data/``: blender, LLFF with NDC rays, ScanNet, LINEMOD, DeepVoxels),
  the image ray sampler, held-out evaluation (``render/path.py``,
  ``utils/evaluation.py``), the metrics files (``utils/metrics.py``) and
  ``--render_only``;
- checkpoints (``utils/checkpoint.py``: save, auto-resume, the import of a
  checkpoint of the JAX package through ``bridge.py``) and baked serving
  (``render/baked.py``: the trained field baked into tile tables, rendered
  by deferred shading; ``serve.py --baked``);
- the online novel-view serving path (``serve.py``): rays ->
  occupancy-guided sampling -> block-hash encode (the hand-written
  ``tent_contract`` CUDA kernel, ``csrc/``) -> NeRFSmall -> compositing,
  forward only under ``torch.inference_mode``;
- the flagship training step (``train/step.py``, ``train/trainer.py``,
  ``bench.py``): the same forward with jittered draws, MSE + entropy +
  block TV, the encode backward (the hand-written ``table_scatter`` CUDA
  kernel), RAdam and the occupancy-grid refresh;
- the ray-structured encodes of that step (``--ray_groups``, whose
  backward is the hand-written ``group_scatter`` CUDA kernel, and
  ``--ray_strides``);
- the tile-interp route of the encode (``--use_pallas`` at the block-hash
  defaults: a row gather under autograd, then the hand-written
  ``tile_interp`` CUDA kernels, forward and ``d rows``), and the public op
  ``ops.lane_select`` with its two CUDA kernels.

The entry points run on the CUDA card (``--device cuda``, the default)
unless the caller asks for the CPU; ``resolve_device`` refuses a card that
is not there rather than switching to the CPU.
"""

import torch

# float32 must mean float32 on the card: the reference computes every
# float32 product in full precision, and TF32 (on by default for cuDNN,
# and opt-in for matmuls) keeps only ~3 decimal digits, which would move
# the MLP outputs far past the tolerances the parity tests hold.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# --precision bf16 multiplies bf16 operands into f32 results (the JAX
# preferred_element_type=float32 dot): the sums stay in f32 throughout.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"


def resolve_device(name: str) -> torch.device:
    """The ``torch.device`` of a ``--device`` value: ``cpu``, ``cuda`` or
    ``cuda:N``. Raises when a CUDA device is asked for and not visible; the
    caller never gets another device than the one it named."""
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"--device {name}: the port runs on cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is visible "
            "(torch.cuda.is_available() is False); pass --device cpu to run "
            "on the CPU")
    count = torch.cuda.device_count()
    if device.index is not None and device.index >= count:
        raise RuntimeError(f"--device {name}: only {count} CUDA device(s) "
                           "visible")
    return device
