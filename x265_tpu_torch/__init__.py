"""x265_tpu_torch: the PyTorch/CUDA port of the x265-tpu HEVC encoder.

Same layout and the same module and function names as the JAX package
beside it, so every counterpart is found by name:

    api/       public parameter + encoder API
    hevc/      spec-level codec: bitstream, NAL, CABAC, headers, syntax
    decoder/   reference HEVC decoder (verification asset)
    ops/       hand-written CUDA kernels' wrappers + their plain versions,
               numpy references
    csrc/      the CUDA C++ sources of those kernels (sm_90a)
    models/    whole-frame batched tensor graphs (plain PyTorch)
    engine/    motion search, mode decision, DPB planes, rate control
    io/        Y4M reader/writer, dither, the ladder's scaler, ReconPlay
    utils/     device choice, upload cache, profiling, state conversion,
               test clips, the assertion mode (checks.py)
    native/    C++ CABAC slice writer, built with g++ at first use

Everything is eager PyTorch on an explicit device. Entry points take
``device=None``, which means the CUDA device; without one they raise
unless the caller passes ``device="cpu"``.

Covered so far: the presets from ``ultrafast`` to ``slow`` (and above it
at ``ref`` 4) with or without ``zerolatency``: CQP/CRF/ABR with VBV, the
lookahead, B frames, the loop filters, AQ, weighted prediction, rd 3-4,
RDOQ, lossless and all-intra, Main10 with scaling lists and HDR10, and
the encodes steered from outside (two-pass, zones, qpfile, ROI maps,
analysis save/load) with the ABR ladder, and the stream structure
(WPP, multi-slice pictures, transform skip, noise reduction, frame-dup,
the histogram scene cut, intra refresh). ``Encoder`` raises
``NotImplementedError`` for every option outside those slices.
"""

__version__ = "0.1.0"
X265_TPU_BUILD = 1

import torch as _torch

# fp32 decision costs (intra SATD bank, ME cost) must not drop to TF32:
# three decimal digits flip argmins. Matmul is already full fp32 by
# default; cuDNN convolutions are not.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from x265_tpu_torch.api.params import Param, param_default, param_default_preset  # noqa: E402,F401
