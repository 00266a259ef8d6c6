"""`.npz` files written and read a block of an array at a time.

An `.npz` is a zip of `.npy` entries, each deflated (numpy's format,
which `np.load` reads).  `NpzWriter` streams an entry: the `.npy` header,
then the array's bytes as its caller hands them over, block by block.  The
bytes are cut into chunks that a pool of threads deflates at once (zlib
releases the GIL); each chunk starts a fresh compressor and ends on a byte
boundary (a sync flush), so the chunks in order, closed by an empty final
block, are one raw deflate stream, and their CRC-32s combine into the
entry's.  The local header's sizes and CRC are written once the entry is
done (the file is seekable).  Sizes and offsets from ZIP64_LIMIT on take
ZIP64 fields (in the local header, a private field of the same length
where no size needs one).

The central directory gives each entry written here a private extra field
(header id `INDEX_ID`) with every chunk's raw and deflated length, which
`zipfile` and `np.load` skip.  `NpzReader` inflates such an entry's chunks
in threads from their offsets, and checks the combined CRC-32; any other
entry (a file numpy or another writer made) it reads through `zipfile` as
one stream.  Either way a block of the array is in host memory at a time.
"""
from __future__ import annotations

import collections
import io
import itertools
import math
import os
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# sizes and offsets from this on take ZIP64 fields, whose 32-bit places
# then hold SATURATED (a test lowers the limit to reach them)
ZIP64_LIMIT = 0xFFFFFFFF
SATURATED = 0xFFFFFFFF
INDEX_ID = 0x6874
PAD_ID = 0x6875
CHUNK_BYTES = 4 << 20
# chunks an entry's index may list: 8 bytes each, inside the extra field's
# 65 535 bytes beside the ZIP64 field
MAX_INDEX_CHUNKS = 8000
THREADS = min(8, os.cpu_count() or 1)
# Two settings of deflate.  FAST, matches at distance 1 only, runs 1.2-1.8
# times faster than level 1 on random field elements held as byte limbs in
# int32 (3 zero bytes in 4) and writes no more; TIGHT, numpy's, is ten
# times slower there but up to twice as small on columns with structure
# (selectors, sparse coefficients).  Each chunk takes TIGHT where TIGHT
# makes its first SAMPLE_BYTES at least 5 % smaller (a chunk that short,
# the smaller of the two).
FAST = (1, zlib.Z_RLE)
TIGHT = (6, zlib.Z_DEFAULT_STRATEGY)
SAMPLE_BYTES = 32 << 10
FINAL_BLOCK = b"\x03\x00"          # an empty final block, fixed codes
_DOS_DATE = (1 << 5) | 1           # 1980-01-01, 00:00
_POLY = 0xEDB88320


def _multmodp(a: int, b: int) -> int:
    """a * b modulo the CRC-32 polynomial (bit-reflected, as zlib)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if not a & (m - 1):
                return p
        m >>= 1
        b = (b >> 1) ^ _POLY if b & 1 else b >> 1


_X2N = [1 << 30]                   # x^(2^k) modulo the polynomial
for _ in range(31):
    _X2N.append(_multmodp(_X2N[-1], _X2N[-1]))
_SHIFTS: dict = {}


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC-32 of A + B from crc1 = crc32(A), crc2 = crc32(B) and
    len(B) (zlib's crc32_combine)."""
    op = _SHIFTS.get(len2)
    if op is None:
        op, n, k = 1 << 31, len2, 3
        while n:
            if n & 1:
                op = _multmodp(_X2N[k & 31], op)
            n >>= 1
            k += 1
        _SHIFTS[len2] = op
    return _multmodp(op, crc1) ^ crc2


def _deflated(buf, setting) -> bytes:
    c = zlib.compressobj(setting[0], zlib.DEFLATED, -15, 8, setting[1])
    return c.compress(buf) + c.flush(zlib.Z_SYNC_FLUSH)


def _deflate(buf) -> tuple:
    if len(buf) <= SAMPLE_BYTES:
        out = min(_deflated(buf, FAST), _deflated(buf, TIGHT), key=len)
    else:
        sample = buf[:SAMPLE_BYTES]
        tight = (len(_deflated(sample, TIGHT))
                 <= 0.95 * len(_deflated(sample, FAST)))
        out = _deflated(buf, TIGHT if tight else FAST)
    return out, zlib.crc32(buf), len(buf)


def npy_header(shape, dtype) -> bytes:
    """The `.npy` header numpy writes for a C-ordered array."""
    f = io.BytesIO()
    np.lib.format.write_array_header_1_0(f, {
        "descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
        "fortran_order": False, "shape": tuple(shape)})
    return f.getvalue()


class NpzWriter:
    """Write an `.npz` entry by entry (`write_array`), then `close`."""

    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.pool = ThreadPoolExecutor(THREADS)
        self.entries = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self.pool.shutdown(cancel_futures=True)
            self.f.close()

    def write_array(self, name: str, shape, dtype, blocks) -> None:
        """Entry `<name>.npy` of an array of `shape` and `dtype` whose bytes,
        in C order, are the buffers of `blocks` in sequence."""
        header = npy_header(shape, dtype)
        usize = len(header) + math.prod(shape) * np.dtype(dtype).itemsize
        offset = self.f.tell()
        chunk = max(CHUNK_BYTES, -(-usize // (MAX_INDEX_CHUNKS // 2)))
        fname = (name + ".npy").encode()
        # the local header's 20 bytes of extra field hold the ZIP64 sizes,
        # or stay a field of PAD_ID, as the sizes turn out
        self.f.write(bytes(30) + fname + bytes(20))
        chunks, pending = [], collections.deque()
        crc = 0

        def drain(limit):
            nonlocal crc
            while len(pending) > limit:
                out, c, n = pending.popleft().result()
                self.f.write(out)
                crc = crc32_combine(crc, c, n)
                chunks.append((n, len(out)))

        raw = 0
        if isinstance(blocks, (bytes, bytearray, memoryview, np.ndarray)):
            blocks = [blocks]
        for buf in itertools.chain([header], blocks):
            mv = memoryview(buf).cast("B")
            raw += len(mv)
            for off in range(0, len(mv), chunk):
                pending.append(self.pool.submit(_deflate, mv[off:off + chunk]))
                drain(2 * THREADS)
        drain(0)
        if raw != usize:
            raise ValueError(f"{name}: {raw} bytes given, {usize} expected")
        self.f.write(FINAL_BLOCK)
        csize = sum(c for _, c in chunks) + len(FINAL_BLOCK)
        z64 = max(usize, csize) >= ZIP64_LIMIT
        end = self.f.tell()
        self.f.seek(offset)
        self.f.write(struct.pack(
            "<IHHHHHIIIHH", 0x04034B50, 45 if z64 else 20, 0, 8, 0,
            _DOS_DATE, crc, SATURATED if z64 else csize,
            SATURATED if z64 else usize, len(fname), 20) + fname
            + (struct.pack("<HHQQ", 1, 16, usize, csize) if z64
               else struct.pack("<HH", PAD_ID, 16) + bytes(16)))
        self.f.seek(end)
        self.entries.append((fname, offset, crc, csize, usize, z64, chunks))

    def close(self) -> None:
        self.pool.shutdown()
        cd_offset = self.f.tell()
        need64 = False
        for fname, offset, crc, csize, usize, z64, chunks in self.entries:
            big_off = offset >= ZIP64_LIMIT
            need64 |= z64 or big_off
            z64_fields = ([usize, csize] if z64 else []) \
                + ([offset] if big_off else [])
            extra = b""
            if z64_fields:
                extra = struct.pack("<HH", 1, 8 * len(z64_fields)) \
                    + struct.pack(f"<{len(z64_fields)}Q", *z64_fields)
            if len(chunks) <= MAX_INDEX_CHUNKS:
                extra += struct.pack("<HH", INDEX_ID, 8 * len(chunks)) \
                    + b"".join(struct.pack("<II", n, c) for n, c in chunks)
            self.f.write(struct.pack(
                "<IHHHHHHIIIHHHHHII", 0x02014B50, 45 if need64 else 20,
                45 if z64_fields else 20, 0, 8, 0, _DOS_DATE, crc,
                SATURATED if z64 else csize, SATURATED if z64 else usize,
                len(fname), len(extra), 0, 0, 0, 0,
                SATURATED if big_off else offset) + fname + extra)
        cd_size = self.f.tell() - cd_offset
        count = len(self.entries)
        need64 |= cd_offset >= ZIP64_LIMIT or cd_size >= ZIP64_LIMIT
        if need64:
            eocd64 = self.f.tell()
            self.f.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0,
                                     0, count, count, cd_size, cd_offset))
            self.f.write(struct.pack("<IIQI", 0x07064B50, 0, eocd64, 1))
        self.f.write(struct.pack(
            "<IHHHHIIH", 0x06054B50, 0, 0, count, count,
            SATURATED if need64 else cd_size,
            SATURATED if need64 else cd_offset, 0))
        self.f.close()


class _Chunks:
    """An indexed entry's bytes, inflated in threads a window of chunks
    ahead, read in order (`readinto`); the CRC-32 is checked at the end."""

    def __init__(self, fd: int, start: int, index: list, crc: int,
                 pool: ThreadPoolExecutor, window: int):
        self.fd, self.pool, self.window = fd, pool, window
        self.todo = collections.deque()
        off = start
        for n, c in index:
            self.todo.append((off, c, n))
            off += c
        self.want_crc, self.crc = crc, 0
        self.pending = collections.deque()
        self.buf, self.pos = memoryview(b""), 0

    @staticmethod
    def _inflate(fd, off, c, n):
        raw = zlib.decompressobj(-15).decompress(os.pread(fd, c, off))
        if len(raw) != n:
            raise zipfile.BadZipFile("a chunk inflated to the wrong length")
        return raw, zlib.crc32(raw)

    def _next(self) -> bool:
        while self.todo and len(self.pending) < self.window:
            self.pending.append(self.pool.submit(self._inflate, self.fd,
                                                 *self.todo.popleft()))
        if not self.pending:
            if self.crc != self.want_crc:
                raise zipfile.BadZipFile("CRC-32 of the entry differs")
            return False
        raw, c = self.pending.popleft().result()
        self.buf = memoryview(raw)
        self.crc = crc32_combine(self.crc, c, len(self.buf))
        self.pos = 0
        return True

    def readinto(self, out) -> int:
        out = memoryview(out).cast("B")
        got = 0
        while got < len(out):
            if self.pos == len(self.buf) and not self._next():
                break
            take = min(len(out) - got, len(self.buf) - self.pos)
            out[got:got + take] = self.buf[self.pos:self.pos + take]
            self.pos += take
            got += take
        return got

    def read(self, size: int) -> bytes:
        out = bytearray(size)
        return bytes(out[:self.readinto(out)])

    def drain(self) -> None:
        """Read to the end, so that the CRC-32 is checked."""
        while self._next():
            pass

    def close(self) -> None:
        for fut in self.pending:
            fut.cancel()


def _read_exact(f, nbytes: int) -> bytearray:
    out = bytearray(nbytes)
    mv, got = memoryview(out), 0
    while got < nbytes:
        n = f.readinto(mv[got:])
        if not n:
            raise zipfile.BadZipFile("entry ends before its array")
        got += n
    return out


class NpzReader:
    """Read the arrays of an `.npz` a block of leading rows at a time."""

    def __init__(self, path: str):
        self.zf = zipfile.ZipFile(path)
        self.fd = os.open(path, os.O_RDONLY)
        self.pool = ThreadPoolExecutor(THREADS)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self.pool.shutdown(cancel_futures=True)
        os.close(self.fd)
        self.zf.close()

    @staticmethod
    def chunk_index(info: zipfile.ZipInfo):
        """An entry's [(raw, deflated) length of each chunk], or None where
        it carries no index that fits its sizes."""
        extra = info.extra
        while len(extra) >= 4:
            tp, ln = struct.unpack("<HH", extra[:4])
            if tp == INDEX_ID:
                body = extra[4:4 + ln]
                index = [struct.unpack("<II", body[i:i + 8])
                         for i in range(0, len(body), 8)]
                if (info.compress_type == zipfile.ZIP_DEFLATED
                        and sum(n for n, _ in index) == info.file_size
                        and sum(c for _, c in index) + len(FINAL_BLOCK)
                        == info.compress_size):
                    return index
                return None
            extra = extra[4 + ln:]
        return None

    def _open(self, name: str):
        info = self.zf.getinfo(name + ".npy")
        index = self.chunk_index(info)
        if index is None:
            return self.zf.open(info)
        head = os.pread(self.fd, 30, info.header_offset)
        nlen, xlen = struct.unpack("<HH", head[26:30])
        return _Chunks(self.fd, info.header_offset + 30 + nlen + xlen, index,
                       info.CRC, self.pool, 2 * THREADS)

    def blocks(self, name: str, block_bytes: int):
        """(shape, iterator): the iterator gives the array of `<name>.npy`
        as arrays of whole leading rows, about `block_bytes` each (a row at
        least)."""
        f = self._open(name)
        version = np.lib.format.read_magic(f)
        read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}[version]
        shape, fortran, dtype = read_header(f)
        if fortran:
            raise ValueError(f"{name}: Fortran-ordered arrays are not read")
        row = math.prod(shape[1:]) * dtype.itemsize

        def it():
            try:
                rows = max(1, block_bytes // max(row, 1))
                for r0 in range(0, shape[0] if shape else 0, rows):
                    r = min(rows, shape[0] - r0)
                    buf = _read_exact(f, r * row)
                    yield np.frombuffer(buf, dtype).reshape((r,) + shape[1:])
                if isinstance(f, _Chunks):
                    f.drain()
            finally:
                f.close()
        return shape, it()
