"""Frozen copy of ``soundswallower_tpu_torch/s3file.py``
for the benchmark's reference (see ``__init__``).

Readers for Sphinx-3 binary model files (means, variances, tmat, mixw, lda).

Reimplements the reference's ``src/s3file.c`` (header parse at :209-319,
byte-order magic 0x11223344 swap detection) on top of numpy.  Unlike the C
code we read fully into numpy arrays instead of mmap+pointer-bump; model
files are small (≈1 MB each) and we want contiguous arrays for device upload.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

BYTE_ORDER_MAGIC = 0x11223344


@dataclass
class S3File:
    """A Sphinx-3 file: parsed header + positioned binary payload."""

    data: bytes
    pos: int = 0
    swap: bool = False
    headers: dict = field(default_factory=dict)
    do_chksum: bool = False

    @classmethod
    def from_file(cls, path: str) -> "S3File":
        with open(path, "rb") as fh:
            return cls(fh.read())

    # -- low-level reads ---------------------------------------------------

    def read_raw(self, nbytes: int) -> bytes:
        if self.pos + nbytes > len(self.data):
            raise EOFError(f"s3file truncated at {self.pos}+{nbytes}")
        out = self.data[self.pos : self.pos + nbytes]
        self.pos += nbytes
        return out

    def read_array(self, dtype, count: int) -> np.ndarray:
        dt = np.dtype(dtype)
        arr = np.frombuffer(self.read_raw(dt.itemsize * count), dtype=dt)
        if self.swap:
            arr = arr.byteswap()
        return arr

    def read_int32(self) -> int:
        return int(self.read_array(np.int32, 1)[0])

    def read_uint32(self) -> int:
        return int(self.read_array(np.uint32, 1)[0])

    # -- header parsing (src/s3file.c:209-319) -----------------------------

    def parse_header(self, version: str | None = None) -> None:
        """Parse the text header + byte-order magic.

        Header format: first line "s3", then "key value" lines until
        "endhdr", then a uint32 byte-order magic.  (The pre-1996 plain
        "version" first-line format is also accepted, per s3file.c.)
        """
        line = self._next_line()
        if line is None:
            raise ValueError("Premature EOF reading s3 header")
        if line.strip() == b"s3":
            while True:
                line = self._next_line()
                if line is None:
                    raise ValueError("Premature EOF in s3 header")
                parts = line.split()
                if not parts:
                    raise ValueError("Missing header line")
                if parts[0] == b"endhdr":
                    break
                if len(parts) >= 2:
                    key = parts[0].decode("utf-8", "replace")
                    val = parts[1].decode("utf-8", "replace")
                    self.headers[key] = val
                    if key == "chksum0":
                        self.do_chksum = True
            # Byte-order magic
            magic = int(np.frombuffer(self.read_raw(4), dtype=np.uint32)[0])
            if magic != BYTE_ORDER_MAGIC:
                swapped = int(
                    np.frombuffer(
                        np.array([magic], dtype=np.uint32).byteswap().tobytes(),
                        dtype=np.uint32,
                    )[0]
                )
                if swapped == BYTE_ORDER_MAGIC:
                    self.swap = True
                else:
                    raise ValueError(f"Bad byte-order magic {magic:#x}")
        else:
            # Old format: first line is version; no byte order info, no swap.
            self.headers["version"] = line.strip().decode("utf-8", "replace")

    def _next_line(self) -> bytes | None:
        if self.pos >= len(self.data):
            return None
        nl = self.data.find(b"\n", self.pos)
        if nl < 0:
            line = self.data[self.pos :]
            self.pos = len(self.data)
        else:
            line = self.data[self.pos : nl]
            self.pos = nl + 1
        return line


def read_gauden_params(path: str):
    """Read a means or variances file (ms_gauden.c:106-204 gauden_param_read).

    Returns (params, n_mgau, n_feat, n_density, veclen) where params is a
    float32 array of shape [n_mgau, n_feat, n_density, max_veclen] (padded
    with zeros if feature streams have different lengths).
    """
    s = S3File.from_file(path)
    s.parse_header("1.0")
    n_mgau = s.read_int32()
    n_feat = s.read_int32()
    n_density = s.read_int32()
    veclen = s.read_array(np.int32, n_feat).tolist()
    blk = sum(veclen)
    n = s.read_int32()
    if n != n_mgau * n_density * blk:
        raise ValueError(
            f"gauden parameter count {n} != {n_mgau}x{n_density}x{blk}"
        )
    buf = s.read_array(np.float32, n)
    maxlen = max(veclen)
    out = np.zeros((n_mgau, n_feat, n_density, maxlen), dtype=np.float32)
    # The file layout is [mgau][feat][density][veclen[feat]] flattened.
    ofs = 0
    for m in range(n_mgau):
        for f in range(n_feat):
            L = veclen[f]
            chunk = buf[ofs : ofs + n_density * L].reshape(n_density, L)
            out[m, f, :, :L] = chunk
            ofs += n_density * L
    return out, n_mgau, n_feat, n_density, veclen


def read_tmat_params(path: str):
    """Read raw transition matrices (tmat.c:125-172 tmat_init_s3file).

    Returns float32 array [n_tmat, n_src, n_dst] (n_dst == n_src+1).
    Normalization/flooring/log-quantization is done by tmat.py.
    """
    s = S3File.from_file(path)
    s.parse_header("1.0")
    n_tmat = s.read_int32()
    n_src = s.read_int32()
    n_dst = s.read_int32()
    n = s.read_int32()
    if n_dst != n_src + 1:
        raise ValueError(f"tmat n_dst({n_dst}) != n_src({n_src})+1")
    if n != n_tmat * n_src * n_dst:
        raise ValueError("tmat array size mismatch")
    tp = s.read_array(np.float32, n).reshape(n_tmat, n_src, n_dst)
    return tp


def write_tmat_params(path: str, tp: np.ndarray):
    """Write raw float32 transition matrices [n_tmat, n_src, n_dst]
    (n_dst == n_src + 1) in the format read_tmat_params / the
    reference's tmat_init_s3file parse."""
    n_tmat, n_src, n_dst = tp.shape
    if n_dst != n_src + 1:
        raise ValueError("tmat n_dst must be n_src + 1")
    with open(path, "wb") as fh:
        _write_s3_header(fh, "1.0")
        fh.write(np.array([n_tmat, n_src, n_dst,
                           n_tmat * n_src * n_dst], np.int32).tobytes())
        fh.write(np.ascontiguousarray(tp, np.float32).tobytes())


def read_sendump(path: str, n_feat: int, n_density: int, n_sen: int):
    """Read a quantized mixture-weight dump (ptm_mgau.c:456-609 read_sendump).

    Returns (mixw, mixw_cb) where mixw is uint8 [n_feat, n_density, c] with
    c = n_sen (8-bit) or (n_sen+1)//2 (4-bit packed two senones per byte),
    and mixw_cb is the 16-entry cluster codebook (uint8) or None.
    """
    s = S3File.from_file(path)
    # Title: int32 length (sanity 1..999 detects byteswap) + NUL-terminated.
    n = int(np.frombuffer(s.read_raw(4), np.int32)[0])
    if n < 1 or n > 999:
        n_sw = int(np.array([n], np.int32).byteswap()[0])
        if n_sw < 1 or n_sw > 999:
            raise ValueError(f"Bad sendump title length {n:#x}")
        s.swap = True
        n = n_sw
    s.read_raw(n)
    # Header string
    n = s.read_int32()
    s.read_raw(n)
    # Attribute strings until zero-length
    n_clust = 0
    n_bits = 8
    f_count, d_count, s_count = n_feat, n_density, n_sen
    while True:
        n = s.read_int32()
        if n == 0:
            break
        attr = s.read_raw(n).split(b"\0")[0].decode("utf-8", "replace")
        for key, setter in (
            ("feature_count ", "f"),
            ("mixture_count ", "d"),
            ("model_count ", "s"),
            ("cluster_count ", "c"),
            ("cluster_bits ", "b"),
        ):
            if attr.startswith(key):
                val = int(attr[len(key):])
                if setter == "f":
                    f_count = val
                elif setter == "d":
                    d_count = val
                elif setter == "s":
                    s_count = val
                elif setter == "c":
                    n_clust = val
                elif setter == "b":
                    n_bits = val
    r, c = d_count, s_count
    if n_clust == 0:
        r = s.read_int32()
        c = s.read_int32()
    if f_count != n_feat or d_count != n_density or s_count != n_sen:
        raise ValueError(
            f"sendump dims mismatch: {f_count}x{d_count}x{s_count} vs "
            f"model {n_feat}x{n_density}x{n_sen}"
        )
    if n_clust not in (0, 15, 16):
        raise ValueError("cluster count must be 0, 15 or 16")
    if n_clust == 15:
        n_clust += 1
    if n_bits not in (4, 8):
        raise ValueError("cluster bits must be 4 or 8")
    mixw_cb = None
    if n_clust:
        mixw_cb = np.frombuffer(s.read_raw(n_clust), dtype=np.uint8).copy()
    step = c
    if n_bits == 4:
        step = (step + 1) // 2
    mixw = np.frombuffer(s.read_raw(n_feat * r * step), dtype=np.uint8)
    mixw = mixw.reshape(n_feat, r, step).copy()
    return mixw, mixw_cb


def read_mixw_float(path: str):
    """Read uncompressed float mixture weights (ptm_mgau.c:611-692 read_mixw).

    Returns float32 [n_sen, n_feat, n_comp] raw probabilities; quantization
    to negated log weights is done by the caller (am.py) since it needs a
    LogMath instance.
    """
    s = S3File.from_file(path)
    s.parse_header("1.0")
    n_sen = s.read_int32()
    n_feat = s.read_int32()
    n_comp = s.read_int32()
    n = s.read_int32()
    if n != n_sen * n_feat * n_comp:
        raise ValueError("mixw array size mismatch")
    pdf = s.read_array(np.float32, n).reshape(n_sen, n_feat, n_comp)
    return pdf


def read_senmgau(path: str) -> np.ndarray:
    """Read a senone->codebook mapping file (senone_mgau_map_read,
    ms_senone.c:33-101; the get_1d variant: int32 count + uint32 data)."""
    s = S3File.from_file(path)
    s.parse_header()
    n = s.read_int32()
    return s.read_array(np.uint32, n).copy()


def _write_s3_header(fh, version: str = "1.0"):
    fh.write(b"s3\n")
    fh.write(f"version {version}\n".encode())
    fh.write(b"endhdr\n")
    fh.write(np.array([BYTE_ORDER_MAGIC], dtype=np.uint32).tobytes())



def write_gauden_params(path: str, params: np.ndarray, veclen: list[int]):
    """Write a means/variances file in the layout gauden_param_read
    consumes (ms_gauden.c:106-204): counts, per-stream veclen, then
    [mgau][feat][density][veclen[feat]] flattened float32."""
    n_mgau, n_feat, n_density, maxlen = params.shape
    assert len(veclen) == n_feat and max(veclen) <= maxlen
    blk = sum(veclen)
    with open(path, "wb") as fh:
        _write_s3_header(fh, "1.0")
        fh.write(np.array([n_mgau, n_feat, n_density], np.int32).tobytes())
        fh.write(np.asarray(veclen, np.int32).tobytes())
        fh.write(np.array([n_mgau * n_density * blk], np.int32).tobytes())
        for m in range(n_mgau):
            for f in range(n_feat):
                fh.write(np.ascontiguousarray(
                    params[m, f, :, :veclen[f]], np.float32).tobytes())

def write_sendump_4b(path: str, cw: np.ndarray, mixw_cb: np.ndarray,
                     n_sen: int):
    """Write a 4-bit clustered sendump (the format read_sendump — and the
    reference's ptm_mgau.c:456-609 — parses in clustered mode: title +
    header + attribute strings, NO rows/cols int32s, 16-byte cluster
    codebook, then packed nibble data).

    cw: uint8 cluster indices [n_feat, n_density, n_sen] (values 0..15);
    senone 2k goes to the LOW nibble, 2k+1 to the HIGH nibble (the
    convention s2_semi_mgau.c:475-499 decodes by senone parity).
    """
    n_feat, n_density, c = cw.shape
    if c != n_sen:
        raise ValueError("cw senone dim mismatch")
    if len(mixw_cb) != 16:
        raise ValueError("cluster codebook must have 16 entries")
    if c % 2:
        cw = np.concatenate([cw, np.zeros((n_feat, n_density, 1), cw.dtype)],
                            axis=2)
    packed = (cw[:, :, 0::2].astype(np.uint8)
              | (cw[:, :, 1::2].astype(np.uint8) << 4))

    def put_str(fh, text: str):
        b = text.encode() + b"\0"
        fh.write(np.array([len(b)], np.int32).tobytes())
        fh.write(b)

    with open(path, "wb") as fh:
        put_str(fh, "4-bit clustered sendump (portbench synth writer)")
        put_str(fh, "comment")
        put_str(fh, "cluster_count 16")
        put_str(fh, "cluster_bits 4")
        put_str(fh, f"feature_count {n_feat}")
        put_str(fh, f"mixture_count {n_density}")
        put_str(fh, f"model_count {n_sen}")
        fh.write(np.array([0], np.int32).tobytes())
        fh.write(np.asarray(mixw_cb, np.uint8).tobytes())
        fh.write(packed.tobytes())
