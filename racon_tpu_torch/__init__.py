"""racon_tpu_torch: the PyTorch/CUDA port of racon-tpu.

Long-read assembly polishing (kC) and fragment correction (kF) with the
consensus engine on an NVIDIA GPU. The package mirrors the JAX package's
layout module for module (``racon_tpu_torch/ops/device_poa.py`` <->
``racon_tpu/ops/device_poa.py``) and is held byte-identical to it; it
imports torch and numpy, never JAX and nothing of the JAX package.

  io.parsers            FASTA/FASTQ/PAF/MHAP/SAM, plain or gzipped
  models.*              Sequence / Overlap / Window / Polisher
  native                host C++ aligner (breaking points, host path)
  ops.poa               PoaEngine: device chunks, redo, host path
  ops.device_poa        one chunk's refinement rounds on the device
  ops.kernels + csrc/   hand-written CUDA forwards (banded, full width)
  ops.band / ops.flat   their plain PyTorch versions
  ops.colwalk           column-walk traceback
  ops.device_merge      vote extraction, aggregation, assembly
  cli                   ``python -m racon_tpu_torch.cli``
"""

__version__ = "0.2.0"
