"""PyTorch + CUDA port of ``inraudio_tpu`` for NVIDIA Hopper (H100).

The JAX package ``inraudio_tpu`` is the reference; this package keeps its
parameter layout (``{"layers": [{"w": (in, out), "b": (out,), "snake_a":
(out,)}]}``, with a leading window axis when stacked) and its payload format,
so parameters and files cross between the two unchanged.  It never imports
JAX.

Ported so far: the codec whole (``codec.load_inr`` -> ``decode`` /
``decode_range`` / ``decode_stream`` / ``decode_many`` -> stitched
waveform; ``codec.encode`` with the multi-INR fit; the shared-backbone
``codec.encode_modulated``; rate planning with ``plan_for_bitrate``), the
single-model fit (``experiments.runner``, ``train.loop.fit``, the KAN), the
sharded fits, and every CLI subcommand (``fit`` for the wave method).  Hand-written CUDA kernels
carry them: the SIREN stack forward (``csrc/siren_stack.cu``), the SIREN
training step and backward (``csrc/siren_train.cu``) and the KAN forward
and backward (``csrc/kan.cu``), each beside its plain PyTorch version.

Float32 matmuls stay true float32 everywhere in the package: TF32 is turned
off here, and the bf16 roundings the decode tiers ask for are emulated
explicitly.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
