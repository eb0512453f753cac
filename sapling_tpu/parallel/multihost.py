"""Multi-host orchestration: replicated index, sharded reads, ordered SAM.

The reference has no distributed anything (SURVEY.md §2: inter-tool
communication is files on disk). The scale-out here:

  * `jax.distributed.initialize` connects N processes, one per GPU; each
    builds or loads the SAME index artifact (read-only, replicated —
    GRCh38 packs to ~1.2 GB packed genome + 12 GB rank arrays).
  * The FASTQ is split into per-process shards by contiguous record
    blocks (deterministic given the process count), each process aligns
    its shard on its own card, and writes SAM records in record order.
  * SAM shards concatenate in record order, so the final file is
    byte-identical to a single-host run — the reference's single-stream
    output contract, kept under data parallelism.

A single process degrades gracefully: shard 0 of 1.
"""

from __future__ import annotations

import os


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids: list[int] | None = None
                           ) -> tuple[int, int]:
    """Connect to the multi-process job (no-op for one process). Returns
    (process_id, num_processes).

    Each process opens only its own card: local_device_ids defaults to
    [process_id], one process per GPU of one host (a JAX process reserves
    most of every card it opens, so a second process on a card fails for
    want of memory). Pass the ids explicitly for other layouts."""
    import jax

    if coordinator and num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=(local_device_ids if local_device_ids
                              is not None else [process_id]),
        )
    return jax.process_index(), jax.process_count()


def shard_bounds(num_records: int, num_shards: int, shard: int) -> tuple[int, int]:
    """Contiguous block shard [lo, hi) — record order preserved across the
    concatenation of shards 0..num_shards-1."""
    per = (num_records + num_shards - 1) // num_shards
    lo = min(shard * per, num_records)
    return lo, min(lo + per, num_records)


def count_fastq_records(path: str) -> int:
    """Streaming record count (4 lines per record; a truncated trailing
    record is dropped, matching the reference reader align.cpp:174-190).

    Validates the 4-line frame as it streams: every record's first line
    must start with '@' and its third with '+' — a blank or stray line
    would otherwise shift every later record boundary and split_fastq
    would silently cut records across shard files."""
    n = 0
    with open(path, "rb") as f:
        for i, line in enumerate(f):
            r = i & 3
            if r == 0 and not line.startswith(b"@"):
                raise ValueError(
                    f"{path}:{i + 1}: malformed FASTQ — record header "
                    f"does not start with '@' (got {line[:20]!r}); "
                    "refusing to shard a frame-shifted file")
            if r == 2 and not line.startswith(b"+"):
                raise ValueError(
                    f"{path}:{i + 1}: malformed FASTQ — separator line "
                    f"does not start with '+' (got {line[:20]!r})")
            n = i + 1
    return n // 4


def split_fastq(path: str, num_shards: int, out_dir: str,
                shard: int | None = None) -> list[str]:
    """Split a FASTQ into contiguous per-shard files, streaming (O(1)
    memory, record lines copied verbatim). With `shard` given, ONLY that
    shard's file is written — each host materializes just its own slice
    instead of every host rewriting the whole input. Returns the
    deterministic path list for ALL shards either way (only the
    requested ones exist on this host)."""
    os.makedirs(out_dir, exist_ok=True)
    total = count_fastq_records(path)
    per = (total + num_shards - 1) // num_shards
    paths = [os.path.join(out_dir, f"shard{s:04d}.fq")
             for s in range(num_shards)]
    want = set(range(num_shards)) if shard is None else {shard}
    outs = {s: open(paths[s], "wb") for s in want}
    try:
        with open(path, "rb") as f:
            it = iter(f)
            for rec in range(total):
                lines = [next(it) for _ in range(4)]
                s = min(rec // per, num_shards - 1) if per else 0
                if s in outs:
                    for ln in lines:
                        outs[s].write(
                            ln if ln.endswith(b"\n") else ln + b"\n")
                elif shard is not None and s > shard:
                    break
    finally:
        for fh in outs.values():
            fh.close()
    return paths


def align_shard(index, fastq_shard: str, out_sam_body: str, cfg=None) -> None:
    """Align one shard, emitting SAM RECORDS ONLY (no header) so shards
    concatenate."""
    from ..align.aligner import SeedExtendAligner
    from ..io.fastq import read_fastq

    aligner = SeedExtendAligner(index, cfg)
    with open(out_sam_body, "w") as f:
        buf = list(read_fastq(fastq_shard))
        # block size + 2-deep host/device pipeline of align_blocks;
        # in-order yield
        # keeps shard bodies byte-deterministic
        blocks = (buf[lo : lo + 8192] for lo in range(0, len(buf), 8192))
        for ars in aligner.align_blocks(blocks):
            for ar in ars:
                f.write(ar.to_sam())


def merge_sam(header: str, shard_bodies: list[str], out_path: str) -> None:
    """Deterministic in-order concatenation — byte-identical to a
    single-stream run."""
    with open(out_path, "w") as f:
        f.write(header)
        for p in shard_bodies:
            with open(p) as g:
                f.write(g.read())


def align_fastq_multihost(index, fastq: str, out_sam: str, cl: str,
                          cfg=None, work_dir: str | None = None) -> None:
    """Full multi-host FASTQ -> SAM: every process aligns its shard; the
    lead process (0) merges. Single-process runs do the whole file."""
    import jax

    from ..align.sam import sam_header

    pid, n = jax.process_index(), jax.process_count()
    work = work_dir or (out_sam + ".shards")
    os.makedirs(work, exist_ok=True)
    shards = split_fastq(fastq, n, work, shard=pid)
    body = os.path.join(work, f"body{pid:04d}.sam")
    align_shard(index, shards[pid], body, cfg)
    if n > 1:
        # cheap cross-host barrier over the existing mesh
        import jax.numpy as jnp

        jax.block_until_ready(
            jax.pmap(lambda x: jax.lax.psum(x, "i"), axis_name="i")(
                jnp.ones((jax.local_device_count(),))))
    if pid == 0:
        bodies = [os.path.join(work, f"body{s:04d}.sam") for s in range(n)]
        merge_sam(sam_header(index.chr_ends, cl), bodies, out_sam)
