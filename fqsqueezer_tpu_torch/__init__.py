"""fqsqueezer_tpu_torch — the PyTorch/CUDA port of fqsqueezer_tpu.

Same codec, same archive format: for the same input and Params its archives
are byte-identical to fqsqueezer_tpu's (see DESIGN.md §5, "Determinism by
construction"). The package stands alone: it keeps its own copies of the
host layer (params, archive container, FASTQ I/O with its native scanner,
corpora, the CLI's argument parser) under the reference package's module
names, and imports torch, never jax and nothing of fqsqueezer_tpu. Only the
tests import both packages. Its entry points run on the first CUDA card
unless the caller asks for the CPU (`device="cpu"`, `--device cpu`).

Ported so far: single-end and paired-end compression and decompression
(pipeline.compress_file, compress_pe, decompress_file; cli `e`, `d`) in
both read orders and every quality and id mode, with three hand-written
CUDA kernels: the rANS encode walks of a group flush (csrc/rans_encode.cu),
the DNA decode scan a read row (csrc/dna_decode.cu) and the quality decode
scan (csrc/qual_decode.cu); every header generation a JAX writer stores;
group snapshots and resume (checkpoint.py); dp x tp mesh archives written
and decoded on one process or on ranks, one a card over NCCL
(parallel.mesh_pipeline, parallel.comm, cli `e -dp/-tp`); the
single-step encoders (pipeline._encode_batch, the streams'
*_encode_batch, parallel.sharded.sharded_encode). Still to come: tp
across cards (see ROADMAP.md).
"""
__version__ = "0.1.0"
