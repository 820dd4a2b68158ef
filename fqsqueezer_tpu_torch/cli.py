"""Command line interface of the port.

The flag surface, the usage text and the one-line errors are the reference
CLI's (fqsqueezer_tpu/cli.py; `parse_args` here is the port's own copy of
it), plus one option of the port's own:

  fqsqueezer_tpu_torch e|d [options] <in> [<in2>]
  -s / -p            single-end / paired-end
  -t <n>             accepted for reference-CLI parity; ignored
  -gs <mbp>          genome size -> k-mer length auto-tuning
  -om o|s            original / sorted read order
  -qm o|8|4|2|n      quality mode
  -qt <n>            binary-quality threshold
  -im o|i|n          id mode
  -out / -out2       output path(s)
  -tmp               temp path prefix
  -v <n>             verbosity
  @list_file         read input names from a file (one per line)
  --device <d>       cuda (the default), cuda:N or cpu

    python -m fqsqueezer_tpu_torch.cli e -s -om o -qm 8 -im n -gs 5 \\
        -out X.fqst in.fastq

    python -m fqsqueezer_tpu_torch.cli d -out X.fastq X.fqst

    python -m fqsqueezer_tpu_torch.cli e -p -gs 5 -out X.fqst r1.fq r2.fq
    python -m fqsqueezer_tpu_torch.cli d -out o1.fq -out2 o2.fq X.fqst

Single-end (-s) and paired-end (-p, two mate files; `d` writes mate 2 to
-out2) reads are ported in original and sorted order (-om o|s; the
default is sorted), every quality mode (-qm o|8|4|2|n, with -qt) and id
mode (-im o|i|n; the default is -im i), for `e` and for `d` (whose modes
come from the archive's header): `e -gs 5 -out X.fqst in.fastq` runs the
defaults, -s -om s -qm 8 -im i. As in the reference CLI, an input above
256 MiB is block-streamed in 256 MiB chunks when its mode streams
(original order, or SE sorted order with -im n); sorted order with ids,
and PE sorted order, load the whole input. `e -dp N -tp M` writes an
archive of a dp x tp mesh, as the reference CLI's -dp/-tp (SE and PE,
the whole input read, never streamed), and `d` of one decodes it
(parallel.mesh_pipeline). Without --device, on a machine whose torch sees
dp cards or more, both run dp ranks, one a card, over NCCL (rank 0
writes the output; the decode is the reference's mesh decode, which
replays the writer's routed s/b exchange); otherwise one process runs the
dp shards in turn (`--device cpu` or `cuda:N` asks for that), and its
decode is the reference's with fewer devices than the mesh. The
reference's rule has the same shape: its mesh where dp x tp devices
exist; the port counts cards against dp alone, since tp stays inside a
card. A mesh the reference cannot shard, a failed rank, and a file that
is not an archive exit 1 with one line. The work runs on the first CUDA
card; a machine without a visible card exits 1 with one line unless
`--device cpu` asks for the CPU.
"""
from __future__ import annotations

import os
import sys
import time

import torch

from .params import DnaMode, IdMode, Params, QualityMode, WorkMode

_USAGE = """fqsqueezer_tpu <mode> [options] <in.fastq> [<in2.fastq>]
mode: e (compress) | d (decompress)
options:
  -s | -p        single-end (default) | paired-end
  -t <n>         accepted for parity; ignored
  -gs <mbp>      genome size estimate in Mbp (default 3100)
  -om <o|s>      read order: original | sorted (default s)
  -qm <o|8|4|2|n> quality: lossless|illumina8|illumina4|binary|none (default 8)
  -qt <n>        quality threshold for -qm 2 (default 20)
  -im <o|i|n>    ids: lossless|instrument|none (default i)
  -out <path>    output path
  -out2 <path>   second output path (PE decompress)
  -dp <n> -tp <n>  multi-chip mesh: data-parallel / table shards (SE only)
  -tmp <path>    temporary file prefix
  -v <n>         verbosity 0-2
"""

# inputs above this total size are block-streamed, in chunks of
# STREAM_CHUNK_BYTES, when their mode streams (the reference CLI's rule)
STREAM_THRESHOLD = 256 << 20
STREAM_CHUNK_BYTES = 256 << 20


def parse_args(argv) -> Params:
    if len(argv) < 2:
        raise SystemExit(_USAGE)
    p = Params()
    mode = argv[0]
    if mode == "e":
        p.work_mode = WorkMode.COMPRESS
    elif mode == "d":
        p.work_mode = WorkMode.DECOMPRESS
    else:
        raise SystemExit(_USAGE)

    i = 1
    pe = False
    order_sorted = True
    files = []
    while i < len(argv):
        a = argv[i]
        if a == "-s":
            pe = False
        elif a == "-p":
            pe = True
        elif a == "-t":
            i += 1
            p.no_threads = max(1, min(64, int(argv[i])))
        elif a == "-gs":
            i += 1
            p.genome_size = int(argv[i])
        elif a == "-om":
            i += 1
            order_sorted = argv[i] == "s"
        elif a == "-qm":
            i += 1
            qm = {"o": QualityMode.LOSSLESS, "8": QualityMode.ILLUMINA_8,
                  "4": QualityMode.ILLUMINA_4, "2": QualityMode.BINARY,
                  "n": QualityMode.NONE}.get(argv[i])
            if qm is None:
                raise SystemExit(f"invalid -qm value '{argv[i]}' (use o|8|4|2|n)")
            p.quality_mode = qm
        elif a == "-qt":
            i += 1
            p.quality_thr = int(argv[i])
        elif a == "-im":
            i += 1
            im = {"o": IdMode.LOSSLESS, "i": IdMode.INSTRUMENT,
                  "n": IdMode.NONE}.get(argv[i])
            if im is None:
                raise SystemExit(f"invalid -im value '{argv[i]}' (use o|i|n)")
            p.id_mode = im
        elif a == "-dp":
            i += 1
            p.mesh_dp = int(argv[i])
        elif a == "-tp":
            i += 1
            p.mesh_tp = int(argv[i])
        elif a == "-out":
            i += 1
            p.out_path = argv[i]
        elif a == "-out2":
            i += 1
            p.out_path2 = argv[i]
        elif a == "-tmp":
            i += 1
            p.tmp_path = argv[i]
        elif a == "-v":
            i += 1
            p.verbosity = int(argv[i])
        elif a.startswith("@"):
            with open(a[1:]) as f:
                files.extend(ln.strip() for ln in f if ln.strip())
        else:
            files.append(a)
        i += 1

    if pe:
        p.dna_mode = DnaMode.PE_SORTED if order_sorted else DnaMode.PE_ORIGINAL
    else:
        p.dna_mode = DnaMode.SE_SORTED if order_sorted else DnaMode.SE_ORIGINAL
    p.file_names = files
    if p.work_mode == WorkMode.COMPRESS:
        p.adjust_kmer_sizes()
        p.auto_tune_lanes()
    return p


def take_device(argv):
    """Split the port-only `--device cpu|cuda|cuda:N` (default cuda) off the
    argv: (device string, the argv parse_args sees)."""
    argv = list(argv)
    device = "cuda"
    while "--device" in argv:
        at = argv.index("--device")
        if at + 1 >= len(argv):
            raise SystemExit("--device needs a value (cpu|cuda|cuda:N)")
        device = argv[at + 1]
        del argv[at:at + 2]
    if device != "cpu" and device != "cuda" and not (
            device.startswith("cuda:") and device[5:].isdigit()):
        raise SystemExit(f"invalid --device value '{device}' "
                         f"(use cpu|cuda|cuda:N)")
    return device, argv


def stream_chunk_bytes(p: Params) -> int:
    """The chunk size `e` streams p.file_names in, or 0 to load them: above
    STREAM_THRESHOLD in all, original order streams in every id mode (PE
    through the paired chunk reader, the first two files) and SE sorted
    order with -im n (its external bin sort carries no ids). A mesh
    (-dp/-tp) never streams."""
    is_pe = p.dna_mode in (DnaMode.PE_ORIGINAL, DnaMode.PE_SORTED)
    total = sum(os.path.getsize(f)
                for f in (p.file_names[:2] if is_pe else p.file_names)
                if os.path.exists(f))
    streams = p.mesh_dp * p.mesh_tp <= 1 and (
        p.dna_mode in (DnaMode.SE_ORIGINAL, DnaMode.PE_ORIGINAL)
        or (p.dna_mode == DnaMode.SE_SORTED and p.id_mode == IdMode.NONE))
    return STREAM_CHUNK_BYTES if streams and total > STREAM_THRESHOLD else 0


def _mesh_dp(p: Params, path: str) -> int:
    """The dp of the archive's mesh, 0 where its header names none (the
    reference CLI's route to mesh_pipeline.decompress_file_mesh)."""
    from .archive import ArchiveReader

    rd = ArchiveReader(path)
    try:
        hdr = Params.load_params(rd.header_blob, base=p)
    finally:
        rd.close()
    return hdr.mesh_dp if hdr.mesh_dp > 1 or hdr.mesh_tp > 1 else 0


def mesh_ranks(device: str, dp: int) -> int:
    """How many ranks run a dp mesh: dp, one a card over NCCL, where the
    device is the default `cuda` and torch sees dp cards or more; else 0,
    one process running the shards in turn."""
    if device != "cuda" or not torch.cuda.is_available():
        return 0
    return dp if torch.cuda.device_count() >= dp else 0


def _mesh_route(p: Params, ranks: int, dp: int) -> None:
    if p.verbosity >= 1:
        print(f"mesh: {ranks} ranks on {ranks} cards (nccl)" if ranks else
              f"mesh: 1 process, {dp} shards in turn")


def _compress(p: Params, device, ranks: int = 0) -> dict:
    """`e`: the reference CLI's routes — a mesh (-dp/-tp) to
    parallel.mesh_pipeline (on `ranks` ranks, one a card, or on one
    process), PE to pipeline.compress_pe, SE to pipeline.compress_file,
    streamed where stream_chunk_bytes says."""
    from . import pipeline

    files = p.file_names
    is_pe = p.dna_mode in (DnaMode.PE_ORIGINAL, DnaMode.PE_SORTED)
    if p.mesh_dp > 1 or p.mesh_tp > 1:
        from .parallel import mesh_pipeline

        _mesh_route(p, ranks, p.mesh_dp)
        if ranks:
            from .parallel import sharded

            # a mesh the tables cannot take fails here, as on one process
            sharded.check_mesh(pipeline.make_configs(p)[0], p.mesh_dp,
                               p.mesh_tp)
            kw = dict(p=p, out_path=p.out_path, dp=p.mesh_dp, tp=p.mesh_tp)
            if is_pe:
                kw.update(in1=files[0], in2=files[1])
            else:
                kw.update(in_path=files[0])
            stats = mesh_pipeline.run_ranks(
                [("compress_pe" if is_pe else "compress", kw)],
                ranks)[0][0]["result"]
        else:
            write = (mesh_pipeline.compress_pe_mesh if is_pe
                     else mesh_pipeline.compress_file_mesh)
            stats = write(p, *files[:1 + is_pe], p.out_path, dp=p.mesh_dp,
                          tp=p.mesh_tp, device=device)
        stats.setdefault("ratio", stats["in_bytes"] / max(
            1, stats["out_bytes"]))
        return stats
    if is_pe:
        return pipeline.compress_pe(p, files[0], files[1], p.out_path,
                                    device=device,
                                    stream_chunk_bytes=stream_chunk_bytes(p))
    return pipeline.compress_file(
        p, files if len(files) > 1 else files[0], p.out_path, device=device,
        stream_chunk_bytes=stream_chunk_bytes(p))


def _decompress(p: Params, device, device_arg: str) -> dict:
    """`d`: a mesh archive to parallel.mesh_pipeline (on ranks, one a
    card, where mesh_ranks says so, else on one process), any other to
    pipeline.decompress_file."""
    from . import pipeline

    dp = _mesh_dp(p, p.file_names[0])
    if not dp:
        return pipeline.decompress_file(p, p.file_names[0], p.out_path,
                                        p.out_path2, device=device)
    from .parallel import mesh_pipeline

    ranks = mesh_ranks(device_arg, dp)
    _mesh_route(p, ranks, dp)
    if ranks:
        return mesh_pipeline.run_ranks([("decompress", dict(
            p_cli=p, in_path=p.file_names[0], out_path=p.out_path,
            out_path2=p.out_path2))], ranks)[0][0]["result"]
    return mesh_pipeline.decompress_file_mesh(
        p, p.file_names[0], p.out_path, p.out_path2, device=device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device_arg, argv = take_device(argv)
    p = parse_args(argv)
    compress = p.work_mode == WorkMode.COMPRESS
    if not p.file_names:
        raise SystemExit("no input files" if compress else "no input archive")
    from . import pipeline

    try:
        device = pipeline.resolve_device(device_arg)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    if p.verbosity >= 1:
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "host CPU")
        print(f"device: {device} ({name})")
    t0 = time.time()
    if compress:
        if (p.dna_mode in (DnaMode.PE_ORIGINAL, DnaMode.PE_SORTED)
                and len(p.file_names) < 2):
            raise SystemExit("paired-end mode needs two input files")
        from .parallel.comm import RankError

        try:
            stats = _compress(p, device, mesh_ranks(device_arg, p.mesh_dp))
        except (ValueError, RankError) as e:
            raise SystemExit(f"error: {e}")
        if p.verbosity >= 1:
            print(f"reads: {stats['n_reads']}  in: {stats['in_bytes']}  "
                  f"out: {stats['out_bytes']}  ratio: {stats['ratio']:.3f}  "
                  f"bits/base: {stats['bits_per_base']:.4f}")
    else:
        from .parallel.comm import RankError

        try:
            stats = _decompress(p, device, device_arg)
        except (OSError, EOFError, ValueError, RankError) as e:
            raise SystemExit(f"error: {e}")
        if p.verbosity >= 1:
            print(f"reads: {stats['n_reads']}")
    if p.verbosity >= 1:
        print(f"time: {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
