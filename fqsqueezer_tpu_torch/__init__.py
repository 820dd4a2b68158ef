"""fqsqueezer_tpu_torch — the PyTorch/CUDA port of fqsqueezer_tpu.

Same codec, same archive format: for the same input and Params its archives
are byte-identical to fqsqueezer_tpu's (see DESIGN.md §5, "Determinism by
construction"). The package stands alone: it keeps its own copies of the
host layer (params, archive container, FASTQ I/O with its native scanner,
corpora, the CLI's argument parser) under the reference package's module
names, and imports torch, never jax and nothing of fqsqueezer_tpu. Only the
tests import both packages. Its entry points run on the first CUDA card
unless the caller asks for the CPU (`device="cpu"`, `--device cpu`).

Ported so far: single-end original-order compression (pipeline.compress_file,
cli `e`), with the rANS encode walks of a group flush as one hand-written
CUDA kernel (csrc/rans_encode.cu). Decompression and the other modes are
still to come (see ROADMAP.md).
"""
__version__ = "0.1.0"
