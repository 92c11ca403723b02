"""Minimal pure-Python LMDB: read the reference's prepared datasets, write
compatible fixtures.

A copy of ``dyadic_interaction_modeling_tpu/utils/lmdb_lite.py``, which the
port keeps so it never imports the JAX package. The reference's PIRender
reads VoxCeleb prepared as an LMDB environment (``Pirender/scripts/
prepare_vox_lmdb.py``, read by ``Pirender/data/vox_dataset.py:345-449``).
The ``lmdb`` C binding is not needed: this module implements the LMDB
on-disk format (symas liblmdb ``mdb.c``) directly:

* ``LmdbReader`` - mmap-backed read-only access to an existing environment
  (``get``/iteration over the main DB's B+tree, overflow pages included), so
  data.mdb files produced by the real liblmdb load as-is;
* ``LmdbWriter`` / ``write_lmdb`` - builds a fresh single-transaction
  environment (sorted leaves, branch hierarchy, overflow pages, dual meta
  pages) that the real liblmdb - and ``LmdbReader`` - can open
  (``render.data.write_vox_lmdb`` writes the reference's layout with it).

Format notes (64-bit little-endian build, the only variant liblmdb ships on
linux-x86_64/arm64): 16-byte page header (pgno u64, pad u16, flags u16,
lower u16, upper u16); meta struct on pages 0/1 (magic 0xBEEFC0DE, version
1, the FREE db's ``md_pad`` carrying the page size); node header (lo u16,
hi u16, flags u16, ksize u16) with leaf datasize = lo | hi<<16 and branch
child pgno = lo | hi<<16 | flags<<32; F_BIGDATA leaf values live on
contiguous overflow pages.  Keys sort bytewise (memcmp), the default
comparator.  Sub-databases, DUPSORT and LEAF2 pages are out of scope - the
reference's prepared data uses none of them.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterable, Iterator, Optional, Tuple

PAGEHDRSZ = 16
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<IIQQ")           # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")         # pad, flags, depth, branch, leaf,
                                         # overflow, entries, root
_META_TAIL = struct.Struct("<QQ")        # last_pg, txnid
_NODE = struct.Struct("<HHHH")           # lo, hi, flags, ksize


def _env_file(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class LmdbReader:
    """Read-only main-DB access to an LMDB environment (dir or .mdb file)."""

    def __init__(self, path: str):
        self.path = _env_file(path)
        self._f = open(self.path, "rb")
        self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = None
        try:
            meta = self._parse_meta(0)
        except (struct.error, ValueError):
            pass
        # meta 1 lives at page 1, i.e. offset psize; without a valid meta 0
        # probe the plausible page sizes
        candidates = ([meta["psize"]] if meta
                      else [4096, 8192, 16384, 32768, 65536])
        for ps in candidates:
            try:
                cand = self._parse_meta(ps)
            except (struct.error, ValueError):
                continue
            if meta is None or cand["txnid"] > meta["txnid"]:
                meta = cand
            break
        if meta is None:
            raise IOError(f"not an LMDB data file: {self.path}")
        self.psize: int = meta["psize"]
        self.entries: int = meta["entries"]
        self._root: int = meta["root"]

    def _parse_meta(self, base: int) -> Dict:
        flags = struct.unpack_from("<H", self._m, base + 10)[0]
        if not flags & P_META:
            raise ValueError("not a meta page")
        off = base + PAGEHDRSZ
        magic, version, _addr, _mapsize = _META.unpack_from(self._m, off)
        if magic != MDB_MAGIC:
            raise ValueError("bad magic")
        if version != MDB_DATA_VERSION:
            raise ValueError(f"unsupported LMDB data version {version}")
        free = _DB.unpack_from(self._m, off + _META.size)
        main = _DB.unpack_from(self._m, off + _META.size + _DB.size)
        last_pg, txnid = _META_TAIL.unpack_from(
            self._m, off + _META.size + 2 * _DB.size)
        psize = free[0] or 4096
        return {"psize": psize, "txnid": txnid, "last_pg": last_pg,
                "root": main[7], "entries": main[6], "depth": main[2]}

    # -- page access --------------------------------------------------------

    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _page_flags(self, pgno: int) -> int:
        return struct.unpack_from("<H", self._m, self._page(pgno) + 10)[0]

    def _numkeys(self, pgno: int) -> int:
        lower = struct.unpack_from("<H", self._m, self._page(pgno) + 12)[0]
        return (lower - PAGEHDRSZ) // 2

    def _node(self, pgno: int, i: int) -> Tuple[int, int, int, bytes, int]:
        """-> (lo|hi<<16, flags, ksize, key, node_offset)."""
        base = self._page(pgno)
        ptr = struct.unpack_from("<H", self._m, base + PAGEHDRSZ + 2 * i)[0]
        off = base + ptr
        lo, hi, flags, ksize = _NODE.unpack_from(self._m, off)
        key = bytes(self._m[off + 8: off + 8 + ksize])
        return lo | (hi << 16), flags, ksize, key, off

    def _leaf_value(self, pgno: int, i: int) -> bytes:
        size, flags, ksize, _key, off = self._node(pgno, i)
        data_off = off + 8 + ksize
        if flags & F_BIGDATA:
            ovpg = struct.unpack_from("<Q", self._m, data_off)[0]
            start = self._page(ovpg) + PAGEHDRSZ
            return bytes(self._m[start: start + size])
        return bytes(self._m[data_off: data_off + size])

    # -- API ----------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        if self._root == P_INVALID:
            return None
        pgno = self._root
        while self._page_flags(pgno) & P_BRANCH:
            n = self._numkeys(pgno)
            # largest child i with node_i.key <= key (node 0's key is empty)
            lo_i, hi_i = 1, n - 1
            child = 0
            while lo_i <= hi_i:
                mid = (lo_i + hi_i) // 2
                _, _, _, k, _ = self._node(pgno, mid)
                if k <= key:
                    child = mid
                    lo_i = mid + 1
                else:
                    hi_i = mid - 1
            pgno = self._node(pgno, child)[0] | (
                self._node(pgno, child)[1] << 32)
        for i in range(self._numkeys(pgno)):
            _, _, _, k, _ = self._node(pgno, i)
            if k == key:
                return self._leaf_value(pgno, i)
            if k > key:
                return None
        return None

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value) pairs in key order."""
        if self._root == P_INVALID:
            return
        stack = [self._root]
        while stack:
            pgno = stack.pop()
            if self._page_flags(pgno) & P_BRANCH:
                kids = []
                for i in range(self._numkeys(pgno)):
                    lohi, flags, _, _, _ = self._node(pgno, i)
                    kids.append(lohi | (flags << 32))
                stack.extend(reversed(kids))
            else:
                for i in range(self._numkeys(pgno)):
                    _, _, _, k, _ = self._node(pgno, i)
                    yield k, self._leaf_value(pgno, i)

    def keys(self) -> Iterator[bytes]:
        for k, _ in self.items():
            yield k

    def close(self):
        self._m.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _PageBuf:
    """One data page being assembled: ptrs grow from the header, node bodies
    from the tail (liblmdb layout)."""

    def __init__(self, psize: int, flags: int):
        self.psize = psize
        self.flags = flags
        self.nodes: list[bytes] = []

    def avail(self) -> int:
        used = PAGEHDRSZ + sum(2 + len(n) for n in self.nodes)
        return self.psize - used

    def fits(self, node_len: int) -> bool:
        return self.avail() >= 2 + node_len

    def add(self, node: bytes):
        self.nodes.append(node)

    def render(self, pgno: int) -> bytes:
        upper = self.psize
        offs = []
        body = bytearray(self.psize)
        for n in self.nodes:
            upper -= len(n)
            body[upper: upper + len(n)] = n
            offs.append(upper)
        lower = PAGEHDRSZ + 2 * len(self.nodes)
        struct.pack_into("<QHHHH", body, 0, pgno, 0, self.flags, lower, upper)
        for i, o in enumerate(offs):
            struct.pack_into("<H", body, PAGEHDRSZ + 2 * i, o)
        return bytes(body)


def _even(n: int) -> int:
    return n + (n & 1)


class LmdbWriter:
    """Build a fresh LMDB environment from sorted (key, value) pairs in one
    shot (the prepare_vox_lmdb write pattern: one big write txn)."""

    def __init__(self, path: str, psize: int = 4096, subdir: bool = True):
        if subdir:
            os.makedirs(path, exist_ok=True)
            self.file = os.path.join(path, "data.mdb")
        else:
            self.file = path
        self.psize = psize
        # liblmdb's inline threshold is me_nodemax = ((psize - PAGEHDRSZ)
        # / MDB_MINKEYS(=2)) & -2; we deliberately use HALF that (//4): values
        # in (~1020, ~2038] bytes go to overflow pages where liblmdb would
        # inline them. Readers don't care (F_BIGDATA is self-describing,
        # both liblmdb and LmdbReader follow the flag) - the conservative
        # threshold just trades a little compactness for never overfilling
        # a leaf.
        self.nodemax = ((psize - PAGEHDRSZ) // 4) & ~1

    def write(self, items: Iterable[Tuple[bytes, bytes]]):
        psize = self.psize
        pairs = sorted(items)
        pages: Dict[int, bytes] = {}   # pgno -> rendered page
        next_pg = 2                    # 0/1 are the meta pages
        n_overflow = 0

        def alloc(count: int = 1) -> int:
            nonlocal next_pg
            pg = next_pg
            next_pg += count
            return pg

        # leaves (+ overflow pages for big values)
        leaves: list[Tuple[bytes, int]] = []   # (first_key, pgno)
        cur = _PageBuf(psize, P_LEAF)
        cur_first: Optional[bytes] = None

        def flush_leaf():
            nonlocal cur, cur_first
            pg = alloc()
            pages[pg] = cur.render(pg)
            leaves.append((cur_first if cur_first is not None else b"", pg))
            cur = _PageBuf(psize, P_LEAF)
            cur_first = None

        for key, val in pairs:
            if len(key) > 511:
                raise ValueError(f"key too long for LMDB: {len(key)}")
            inline = 8 + len(key) + len(val)
            if inline <= self.nodemax:
                node = _NODE.pack(len(val) & 0xFFFF, len(val) >> 16, 0,
                                  len(key)) + key + val
            else:
                ovcount = -(-(PAGEHDRSZ + len(val)) // psize)
                ovpg = alloc(ovcount)
                n_overflow += ovcount
                raw = bytearray(ovcount * psize)
                struct.pack_into("<QHHI", raw, 0, ovpg, 0, P_OVERFLOW, ovcount)
                raw[PAGEHDRSZ: PAGEHDRSZ + len(val)] = val
                for j in range(ovcount):
                    pages[ovpg + j] = bytes(raw[j * psize: (j + 1) * psize])
                node = _NODE.pack(len(val) & 0xFFFF, len(val) >> 16,
                                  F_BIGDATA, len(key)) + key + \
                    struct.pack("<Q", ovpg)
            node = node + b"\0" * (_even(len(node)) - len(node))
            if not cur.fits(len(node)):
                flush_leaf()
            if cur_first is None:
                cur_first = key
            cur.add(node)
        if cur.nodes or not leaves:
            flush_leaf()

        # branch levels until a single root
        n_branch = 0
        level = leaves
        depth = 1
        while len(level) > 1:
            nxt: list[Tuple[bytes, int]] = []
            buf = _PageBuf(psize, P_BRANCH)
            first: Optional[bytes] = None

            def branch_node(key: bytes, child: int, is_first: bool) -> bytes:
                k = b"" if is_first else key   # leftmost key is implicit
                n = _NODE.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                               (child >> 32) & 0xFFFF, len(k)) + k
                return n + b"\0" * (_even(len(n)) - len(n))

            def flush_branch():
                nonlocal buf, first, n_branch
                pg = alloc()
                pages[pg] = buf.render(pg)
                n_branch += 1
                nxt.append((first if first is not None else b"", pg))
                buf = _PageBuf(psize, P_BRANCH)
                first = None

            for key, child in level:
                node = branch_node(key, child, is_first=not buf.nodes)
                if not buf.fits(len(node)):
                    flush_branch()
                    node = branch_node(key, child, is_first=True)
                if first is None:
                    first = key
                buf.add(node)
            if buf.nodes:
                flush_branch()
            level = nxt
            depth += 1
        root = level[0][1]
        n_leaf = len(leaves)

        # metas: page 0 carries txnid 1 (the committed txn), page 1 txnid 0
        def meta_page(pgno: int, txnid: int) -> bytes:
            body = bytearray(psize)
            struct.pack_into("<QHHHH", body, 0, pgno, 0, P_META, 0, 0)
            off = PAGEHDRSZ
            _META.pack_into(body, off, MDB_MAGIC, MDB_DATA_VERSION, 0,
                            max(next_pg * psize, 1 << 20))
            _DB.pack_into(body, off + _META.size,           # FREE db
                          psize, 0, 0, 0, 0, 0, 0, P_INVALID)
            _DB.pack_into(body, off + _META.size + _DB.size,  # MAIN db
                          0, 0, depth if pairs else 0, n_branch, n_leaf,
                          n_overflow, len(pairs),
                          root if pairs else P_INVALID)
            _META_TAIL.pack_into(body, off + _META.size + 2 * _DB.size,
                                 next_pg - 1, txnid)
            return bytes(body)

        with open(self.file, "wb") as f:
            f.write(meta_page(0, 1))
            f.write(meta_page(1, 0))
            for pg in range(2, next_pg):
                f.write(pages[pg])


def write_lmdb(path: str, items: Iterable[Tuple[bytes, bytes]],
               psize: int = 4096, subdir: bool = True):
    """Convenience: build an LMDB environment at ``path`` from (key, value)
    byte pairs (keys need not be pre-sorted)."""
    LmdbWriter(path, psize=psize, subdir=subdir).write(items)


def format_for_lmdb(*args) -> bytes:
    """The reference's key convention (vox_dataset.py:13-19 /
    prepare_vox_lmdb.py:15-21): ints zero-padded to 7 digits, parts joined
    with '-', utf-8 encoded."""
    parts = []
    for a in args:
        if isinstance(a, int):
            a = str(a).zfill(7)
        parts.append(a)
    return "-".join(parts).encode("utf-8")
