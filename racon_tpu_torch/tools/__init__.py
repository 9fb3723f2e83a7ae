"""Command-line tools around the polisher (port of the JAX package's
``tools/``): ``rampler`` (subsample and split sequence files) and
``wrapper`` (racon_wrapper: subsample the reads, split the targets,
polish chunk by chunk with resume). Run them as
``python -m racon_tpu_torch.tools.<name>``."""
