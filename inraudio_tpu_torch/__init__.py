"""PyTorch + CUDA port of ``inraudio_tpu`` for NVIDIA Hopper (H100).

The JAX package ``inraudio_tpu`` is the reference; this package keeps its
parameter layout (``{"layers": [{"w": (in, out), "b": (out,), "snake_a":
(out,)}]}``, with a leading window axis when stacked) and its payload format,
so parameters and files cross between the two unchanged.  It never imports
JAX.

Ported so far: the codec's decode path (``codec.load_inr`` -> ``decode`` /
``decode_range`` -> stitched waveform), with the SIREN stack forward as a
hand-written CUDA kernel (``ops/siren_fused.py``, ``csrc/siren_stack.cu``).

Float32 matmuls stay true float32 everywhere in the package: TF32 is turned
off here, and the bf16 roundings the decode tiers ask for are emulated
explicitly.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
