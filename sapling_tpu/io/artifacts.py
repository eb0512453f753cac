"""Index artifact (de)serialization.

Two formats:
  * Reference-compatible `.sa` / `.sap` flat binaries, bit-for-bit
    interchangeable with files produced by the C++ reference
    (.sa layout: src/sapling_api.h:559-603 & suffixarray/addlcp.cpp:69-77;
     .sap layout: src/sapling_api.h:613-675 including the 32-bit-size quirk
     for buckets <= 30).
  * A native .npz artifact with the packed/typed arrays the engine
    actually loads (fast reload path; the reference's pattern of
    write-once / transparently-reload is preserved).

All .sa/.sap integers are little-endian 64-bit size_t / long long as on the
reference's x86-64 targets.
"""

from __future__ import annotations

import os

import numpy as np


def write_sa(path: str, inv: np.ndarray, lcp: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.array([inv.shape[0]], dtype="<u8").tofile(f)
        inv.astype("<u8").tofile(f)
        np.array([lcp.shape[0]], dtype="<u8").tofile(f)
        lcp.astype("<u8").tofile(f)


def read_sa(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        n = int(np.fromfile(f, dtype="<u8", count=1)[0])
        inv = np.fromfile(f, dtype="<u8", count=n)
        m = int(np.fromfile(f, dtype="<u8", count=1)[0])
        lcp = np.fromfile(f, dtype="<u8", count=m)
    if inv.shape[0] != n or lcp.shape[0] != m:
        raise IOError(f"truncated .sa file: {path}")
    return inv, lcp


def write_sap(path: str, buckets: int, xlist: np.ndarray, ylist: np.ndarray,
              max_over: int, max_under: int, mean_error: int,
              most_over: int, most_under: int) -> None:
    size = (1 << buckets) + 1
    assert xlist.shape[0] == size and ylist.shape[0] == size
    with open(path, "wb") as f:
        np.array([buckets], dtype="<i4").tofile(f)
        if buckets <= 30:
            np.array([size], dtype="<i4").tofile(f)
        else:
            np.array([size], dtype="<u8").tofile(f)
        xlist.astype("<i8").tofile(f)
        ylist.astype("<i8").tofile(f)
        np.array([max_over, max_under, mean_error, most_over, most_under],
                 dtype="<i4").tofile(f)


def read_sap(path: str):
    with open(path, "rb") as f:
        buckets = int(np.fromfile(f, dtype="<i4", count=1)[0])
        if buckets <= 30:
            size = int(np.fromfile(f, dtype="<i4", count=1)[0])
        else:
            size = int(np.fromfile(f, dtype="<u8", count=1)[0])
        xlist = np.fromfile(f, dtype="<i8", count=size)
        ylist = np.fromfile(f, dtype="<i8", count=size)
        stats = np.fromfile(f, dtype="<i4", count=5)
    if xlist.shape[0] != size or ylist.shape[0] != size or stats.shape[0] != 5:
        raise IOError(f"truncated .sap file: {path}")
    return buckets, xlist, ylist, tuple(int(s) for s in stats)


def write_errors_text(path: str, kmers: np.ndarray, inv: np.ndarray,
                      pred: np.ndarray, errors: np.ndarray, buckets: int,
                      chunk: int = 1 << 22) -> None:
    """Reference `.errors` dump: a `buckets` header line (reference
    src/sapling_api.h:399 — PerBinErrors.java parses it as the bin
    count), then one line per genome k-mer,
    `"%lld %zu %zu %d" % (hash, true_rank, predicted_rank, error)`
    (src/sapling_api.h:467) — the input format of
    eval/ErrorsPerBin/PerBinErrors.java and eval/HighlightBins.
    All-integer decimal columns; byte-identical to the reference
    binary's errFn output (tests/test_interop.py)."""
    m = kmers.shape[0]
    with open(path, "wb") as f:
        f.write(f"{buckets}\n".encode())
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            cols = np.empty((hi - lo, 4), dtype=np.int64)
            cols[:, 0] = kmers[lo:hi]
            cols[:, 1] = inv[lo:hi]
            cols[:, 2] = pred[lo:hi]
            cols[:, 3] = errors[lo:hi]
            np.savetxt(f, cols, fmt="%d")


def save_npz(path: str, **arrays) -> None:
    tmp = path + f".tmp{os.getpid()}"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_npz(path: str, skip: tuple = (), mmap: bool = False) -> dict:
    """Load a save_npz artifact.

    skip: member names to leave out entirely (e.g. the 12.4 GB `inv`
    when only the query path is needed — it is ~40% of a GRCh38
    artifact's load time).

    mmap=True memory-maps every large member in place instead of
    copying it into RAM: save_npz writes an UNCOMPRESSED zip
    (np.savez), so each member's .npy payload sits at a fixed offset
    in the file and np.memmap can address it directly. First touch
    still pages bytes in from disk, but (a) untouched members cost
    nothing, (b) repeat loads in later processes ride the OS page
    cache, and (c) load() returns in milliseconds instead of minutes
    at multi-GB scale. Small members (< 1 MB)
    are materialized — header-only metadata reads stay cheap and the
    returned dict's scalars behave normally."""
    if not mmap:
        with np.load(path, allow_pickle=True) as z:
            return {k: z[k] for k in z.files if k not in skip}
    import zipfile

    out = {}
    with zipfile.ZipFile(path) as zf:
        for zinfo in zf.infolist():
            name = zinfo.filename
            key = name[:-4] if name.endswith(".npy") else name
            if key in skip:
                continue
            with zf.open(name) as f:
                version = np.lib.format.read_magic(f)
                np.lib.format._check_version(version)
                shape, fortran, dtype = \
                    np.lib.format._read_array_header(f, version)
                hdr_len = f.tell()  # data offset within the member
                nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                if (zinfo.compress_type != zipfile.ZIP_STORED
                        or dtype.hasobject or nbytes < (1 << 20)):
                    out[key] = np.frombuffer(
                        f.read(), dtype=dtype).reshape(
                            shape, order="F" if fortran else "C") \
                        if not dtype.hasobject else np.lib.format.read_array(
                            zf.open(name), allow_pickle=True)
                    continue
            # zip local header: 30 fixed bytes + name + extra. The extra
            # field length in the CENTRAL directory can differ from the
            # local one — read the lengths from the local header itself.
            with open(path, "rb") as raw:
                raw.seek(zinfo.header_offset + 26)
                nlen, elen = np.frombuffer(raw.read(4), "<u2")
            data_off = (zinfo.header_offset + 30 + int(nlen) + int(elen)
                        + hdr_len)
            out[key] = np.memmap(path, dtype=dtype, mode="r",
                                 offset=data_off, shape=shape,
                                 order="F" if fortran else "C")
    return out
