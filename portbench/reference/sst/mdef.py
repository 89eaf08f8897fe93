"""Frozen copy of ``soundswallower_tpu_torch/mdef.py``
for the benchmark's reference (see ``__init__``).

Binary model definition (mdef) reader.

Reimplements ``src/bin_mdef.c`` (binary layout at :332-525, cd_tree triphone
lookup at :597-717) as numpy arrays.  The mdef maps:

* CI phone names <-> ids (first ``n_ciphone`` phones)
* (base, left-ctx, right-ctx, word-position) -> CD phone id, via a 4-level
  search tree (``cd_tree``)
* phone id -> senone sequence id (ssid) and transition matrix id
* ssid -> per-state senone ids (``sseq[ssid][state]``)
* derived maps ``cd2cisen`` and ``sen2cimap`` (bin_mdef.c:487-519)
"""

from __future__ import annotations

import numpy as np

BIN_MDEF_NATIVE_ENDIAN = 0x46444D42  # 'BMDF' little-endian
BIN_MDEF_OTHER_ENDIAN = 0x424D4446
BAD_SSID = 0xFFFF

# Word position enum (s3types.h word_posn_t)
WORD_POSN_INTERNAL = 0
WORD_POSN_BEGIN = 1
WORD_POSN_END = 2
WORD_POSN_SINGLE = 3
WORD_POSN_UNDEFINED = 4
N_WORD_POSN = 4

S3_SILENCE_CIPHONE = "SIL"


def read_mdef(path: str) -> "BinMdef":
    """Read a model definition, text or binary (bin_mdef_read tries the
    text parser first, bin_mdef.c:309-318)."""
    with open(path, "rb") as fh:
        head = fh.read(4)
    if head in (b"BMDF", b"FDMB"):
        return BinMdef(path)
    return BinMdef.from_text(path)


class BinMdef:
    """In-memory binary model definition (reference: bin_mdef.h:119-148)."""

    @classmethod
    def from_text(cls, path: str) -> "BinMdef":
        """Text-format mdef parser (mdef_init, mdef.c:488-665 +
        bin_mdef_read_text's senone-sequence compression,
        bin_mdef.c:166-250)."""
        lines = []
        with open(path, encoding="utf-8") as fh:
            for raw in fh:
                line = raw.strip()
                if line and not line.startswith("#"):
                    lines.append(line)
        it = iter(lines)
        version = next(it)
        if not version.startswith("0.3"):
            raise ValueError(f"mdef version error: expected 0.3, got {version}")
        hdr = {}
        while len(hdr) < 6:
            n, tag = next(it).split()[:2]
            hdr[tag] = int(n)
        n_ci = hdr["n_base"]
        n_tri = hdr["n_tri"]
        n_map = hdr["n_state_map"]
        n_emit = n_map // (n_ci + n_tri) - 1
        if (n_emit + 1) * (n_ci + n_tri) != n_map:
            raise ValueError("n_state_map not a multiple of n_ci+n_tri")

        m = cls.__new__(cls)
        m.n_ciphone = n_ci
        m.n_phone = n_ci + n_tri
        m.n_emit_state = n_emit
        m.n_ci_sen = hdr["n_tied_ci_state"]
        m.n_sen = hdr["n_tied_state"]
        m.n_tmat = hdr["n_tied_tmat"]
        m.n_ctx = 3
        m._swap = False

        wpos_of = {"b": WORD_POSN_BEGIN, "e": WORD_POSN_END,
                   "s": WORD_POSN_SINGLE, "i": WORD_POSN_INTERNAL}
        names: list[str] = []
        filler = np.zeros(m.n_phone, np.uint8)
        senmap = np.zeros((m.n_phone, n_emit), np.uint16)
        tmat_of = np.zeros(m.n_phone, np.int32)
        ci_of = np.zeros(m.n_phone, np.int32)
        cd_map: dict = {}
        name2id: dict[str, int] = {}
        info = np.zeros((m.n_phone, 4), np.uint8)
        for p in range(m.n_phone):
            toks = next(it).split()
            name, lc_s, rc_s, wpos_s, attrib, tmat = toks[:6]
            states = toks[6:]
            if states[-1] != "N":
                raise ValueError(f"mdef line does not end in N: {toks}")
            sen = [int(x) for x in states[:-1]]
            if len(sen) != n_emit:
                raise ValueError("Wrong number of emitting states")
            if p < n_ci:
                if lc_s != "-" or rc_s != "-" or wpos_s != "-":
                    raise ValueError("Bad context info for base phone")
                names.append(name)
                name2id[name] = p
                ci_of[p] = p
                if attrib == "filler":
                    filler[p] = 1
                    info[p, 0] = 1
            else:
                ci = name2id[name]
                lc = name2id[lc_s]
                rc = name2id[rc_s]
                wpos = wpos_of[wpos_s]
                ci_of[p] = ci
                info[p, 0] = wpos
                info[p, 1] = ci & 0xFF
                info[p, 2] = lc & 0xFF
                info[p, 3] = rc & 0xFF
                cd_map[(wpos, ci, lc, rc)] = p
            senmap[p] = sen
            tmat_of[p] = int(tmat)

        # Compress senone sequences to unique ssids (bin_mdef_read_text)
        uniq, inverse = np.unique(senmap, axis=0, return_inverse=True)
        m.sseq = uniq.astype(np.uint16)
        m.sseq_len = None
        m.n_sseq = len(uniq)
        m.n_cd_tree = len(cd_map)
        m._cd_map = cd_map
        m.phone_ssid = inverse.astype(np.int32)
        m.phone_tmat = tmat_of
        m.phone_info = info
        m.ciname = names
        m._ciname2id = name2id
        m._pid2ci = ci_of
        m.cd_ctx = m.cd_ndown = m.cd_down = np.zeros(0, np.int16)

        # cd2cisen / sen2cimap (same derivation as the binary path)
        m.cd2cisen = np.full(m.n_sen, -1, np.int16)
        m.sen2cimap = np.full(m.n_sen, -1, np.int16)
        m.cd2cisen[: m.n_ci_sen] = np.arange(m.n_ci_sen, dtype=np.int16)
        sens = m.sseq[m.phone_ssid].astype(np.int64)
        ci_sens = m.sseq[m.phone_ssid[ci_of]].astype(np.int16)
        for j in range(n_emit):
            m.cd2cisen[sens[:, j]] = ci_sens[:, j]
            m.sen2cimap[sens[::-1, j]] = ci_of[::-1].astype(np.int16)
        m.sil = m.ciphone_id(S3_SILENCE_CIPHONE)
        return m

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        buf = np.frombuffer(data, dtype=np.uint8)
        pos = 0

        def rd_i32(n=1):
            nonlocal pos
            arr = buf[pos : pos + 4 * n].view(np.int32)
            if self._swap:
                arr = arr.byteswap()
            pos += 4 * n
            return arr

        self._swap = False
        magic = int(buf[0:4].view(np.int32)[0])
        pos = 4
        if magic == BIN_MDEF_OTHER_ENDIAN:
            self._swap = True
        elif magic != BIN_MDEF_NATIVE_ENDIAN:
            raise ValueError("Not a binary mdef file")
        version = int(rd_i32()[0])
        if version > 1:
            raise ValueError(f"mdef format version {version:#x} too new")
        hdrlen = int(rd_i32()[0])
        pos += hdrlen

        (
            self.n_ciphone,
            self.n_phone,
            self.n_emit_state,
            self.n_ci_sen,
            self.n_sen,
            self.n_tmat,
            self.n_sseq,
            self.n_ctx,
            self.n_cd_tree,
            self.sil,
        ) = (int(x) for x in rd_i32(10))

        # CI phone names: NUL-terminated strings.  Offsets for the padding
        # below are measured from the start of this block (bin_mdef.c:423-425).
        name0 = pos
        names = []
        for _ in range(self.n_ciphone):
            end = data.index(b"\0", pos)
            names.append(data[pos:end].decode("utf-8"))
            pos = end + 1
        self.ciname = names
        self._ciname2id = {n: i for i, n in enumerate(names)}

        tree_start = (pos - name0 + 3) & ~3
        pos = name0 + tree_start

        # cd_tree: n_cd_tree x {int16 ctx, int16 n_down, int32 down} (8B)
        cd_raw = buf[pos : pos + 8 * self.n_cd_tree]
        self.cd_ctx = cd_raw.reshape(-1, 8)[:, 0:2].copy().view(np.int16).ravel()
        self.cd_ndown = cd_raw.reshape(-1, 8)[:, 2:4].copy().view(np.int16).ravel()
        self.cd_down = cd_raw.reshape(-1, 8)[:, 4:8].copy().view(np.int32).ravel()
        if self._swap:
            self.cd_ctx = self.cd_ctx.byteswap()
            self.cd_ndown = self.cd_ndown.byteswap()
            self.cd_down = self.cd_down.byteswap()
        pos += 8 * self.n_cd_tree

        # phone entries: {int32 ssid, int32 tmat, 4 bytes info} (12B packed)
        ph_raw = buf[pos : pos + 12 * self.n_phone].reshape(-1, 12)
        self.phone_ssid = ph_raw[:, 0:4].copy().view(np.int32).ravel()
        self.phone_tmat = ph_raw[:, 4:8].copy().view(np.int32).ravel()
        if self._swap:
            self.phone_ssid = self.phone_ssid.byteswap()
            self.phone_tmat = self.phone_tmat.byteswap()
        # info union: CI phones have .ci.filler in byte 0; CD phones have
        # .cd.{wpos, ctx[3]}.  Byte order is within-byte so no swap needed.
        self.phone_info = ph_raw[:, 8:12].copy()
        pos += 12 * self.n_phone

        sseq_size = int(buf[pos : pos + 4].view(np.int32)[0])
        if self._swap:
            sseq_size = int(np.array([sseq_size], np.int32).byteswap()[0])
        pos += 4
        sseq_flat = buf[pos : pos + 2 * sseq_size].copy().view(np.uint16)
        if self._swap:
            sseq_flat = sseq_flat.byteswap()
        pos += 2 * sseq_size
        if self.n_emit_state:
            self.sseq = sseq_flat.reshape(self.n_sseq, self.n_emit_state)
            self.sseq_len = None
        else:
            self.sseq_len = buf[pos : pos + self.n_sseq].copy()
            pos += self.n_sseq
            # Heterogeneous topologies: keep flat + offsets
            offs = np.concatenate([[0], np.cumsum(self.sseq_len[:-1])])
            self._sseq_flat = sseq_flat
            self._sseq_off = offs
            self.sseq = None

        # Derived mappings (bin_mdef.c:487-519)
        self.cd2cisen = np.full(self.n_sen, -1, dtype=np.int16)
        self.sen2cimap = np.full(self.n_sen, -1, dtype=np.int16)
        self.cd2cisen[: self.n_ci_sen] = np.arange(self.n_ci_sen, dtype=np.int16)
        if self.sseq is not None:
            # CI id of each phone: bin_mdef_pid2ci (bin_mdef.h:167-168) -
            # CI phones map to themselves, CD phones to info.cd.ctx[0]
            # (info layout: byte0=wpos, bytes1..3=ctx[0..2], ctx[0]=base).
            ci = np.arange(self.n_phone, dtype=np.int32)
            cd_mask = ci >= self.n_ciphone
            ci[cd_mask] = self.phone_info[cd_mask, 1].astype(np.int32)
            self._pid2ci = ci
            # Vectorized equivalent of the per-phone loop at bin_mdef.c:499-519:
            # for each phone p, state j: s = sseq[ssid[p], j];
            #   sen2cimap[s] = ci[p] (first phone referencing s wins)
            #   cd2cisen[s] = sseq[ssid[ci[p]], j] (last write wins; all agree)
            sens = self.sseq[self.phone_ssid].astype(np.int64)  # [n_phone, S]
            ci_sens = self.sseq[self.phone_ssid[ci]].astype(np.int16)
            for j in range(self.n_emit_state):
                self.cd2cisen[sens[:, j]] = ci_sens[:, j]
                # first-wins: assign in reverse phone order so that the
                # earliest phone's value lands last.
                self.sen2cimap[sens[::-1, j]] = ci[::-1].astype(np.int16)
        # Silence phone id by name (authoritative; header sil field may be -1)
        self.sil = self.ciphone_id(S3_SILENCE_CIPHONE)

    # -- queries -----------------------------------------------------------

    def ciphone_id(self, name: str) -> int:
        return self._ciname2id.get(name, -1)

    def ciphone_str(self, pid: int) -> str:
        return self.ciname[pid]

    def is_filler(self, pid: int) -> bool:
        """bin_mdef_is_fillerphone: CI phones use info.ci.filler."""
        if pid < self.n_ciphone:
            return bool(self.phone_info[pid, 0])
        return bool(self.phone_info[int(self._pid2ci[pid]), 0])

    def pid2ssid(self, pid: int) -> int:
        return int(self.phone_ssid[pid])

    def pid2tmatid(self, pid: int) -> int:
        return int(self.phone_tmat[pid])

    def pid2ci(self, pid: int) -> int:
        return int(self._pid2ci[pid])

    def sseq2sen(self, ssid: int, state: int) -> int:
        return int(self.sseq[ssid, state])

    def _build_cd_map(self) -> dict:
        """Flatten cd_tree into {(wpos, ci, lc, rc): pid}.

        Equivalent to exhaustively walking bin_mdef.c:630-661; a dict lookup
        replaces the 4-level linear scans, which matters because
        dict2pid_build makes O(n_ci^2 * n_ci) lookups.
        """
        cd_map: dict = {}
        ctx = self.cd_ctx
        ndown = self.cd_ndown
        down = self.cd_down
        # level-order DFS carrying the (wpos, ci, lc) prefix
        stack = [(0, N_WORD_POSN, 0, ())]
        while stack:
            base, max_n, level, prefix = stack.pop()
            for i in range(base, base + max_n):
                key = prefix + (int(ctx[i]),)
                if ndown[i] == 0:
                    cd_map[key] = int(down[i])
                else:
                    stack.append((int(down[i]), int(ndown[i]), level + 1, key))
        return cd_map

    def phone_id(self, ci: int, lc: int, rc: int, wpos: int) -> int:
        """Exact CD phone lookup via cd_tree (bin_mdef.c:597-665)."""
        if lc < 0 and rc < 0 and wpos == WORD_POSN_UNDEFINED:
            return ci
        if self.n_cd_tree == 0 or lc < 0 or rc < 0 or wpos == WORD_POSN_UNDEFINED:
            return -1
        cd_map = getattr(self, "_cd_map", None)
        if cd_map is None:
            cd_map = self._cd_map = self._build_cd_map()
        sil = self.sil
        key = (
            wpos,
            ci,
            sil if (sil >= 0 and self.phone_info[lc, 0]) else lc,
            sil if (sil >= 0 and self.phone_info[rc, 0]) else rc,
        )
        p = cd_map.get(key, -1)
        if p >= 0:
            return p
        # A leaf may terminate the C walk at an intermediate level
        # (bin_mdef.c:654-655); cover that with prefix keys.
        for n in (3, 2, 1):
            p = cd_map.get(key[:n], -1)
            if p >= 0:
                return p
        return -1

    def phone_id_nearest(self, b: int, l: int, r: int, pos: int) -> int:
        """CD phone lookup with backoff (bin_mdef.c:667-717)."""
        if l < 0 or r < 0:
            return b
        p = self.phone_id(b, l, r, pos)
        if p >= 0:
            return p
        for tmppos in range(N_WORD_POSN):
            if tmppos != pos:
                p = self.phone_id(b, l, r, tmppos)
                if p >= 0:
                    return p
        if self.sil >= 0:
            newl, newr = l, r
            if self.phone_info[l, 0] or pos in (WORD_POSN_BEGIN, WORD_POSN_SINGLE):
                newl = self.sil
            if self.phone_info[r, 0] or pos in (WORD_POSN_END, WORD_POSN_SINGLE):
                newr = self.sil
            if newl != l or newr != r:
                p = self.phone_id(b, newl, newr, pos)
                if p >= 0:
                    return p
                for tmppos in range(N_WORD_POSN):
                    if tmppos != pos:
                        p = self.phone_id(b, newl, newr, tmppos)
                        if p >= 0:
                            return p
        return b

    @property
    def silphone(self) -> int:
        return self.sil
