"""A numpy-only reader for the HDF5 subset that keras-style NIF weights use.

The plain reference reads the configuration's ``converted.hdf5`` with
this frozen copy, not with the renderer's loader, so that the weights it
computes with are its own reading of the raw file.  It covers what h5py
writes with its default ("earliest") format: superblock version 0,
version-1 object headers, symbol-table groups, contiguous datasets of
little-endian floats and string attributes; anything else raises
ValueError naming what it met.
"""

from __future__ import annotations

import struct

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Reader:
    def __init__(self, blob: bytes):
        if blob[:8] != _SIGNATURE:
            raise ValueError("not an HDF5 file")
        if blob[8] != 0:
            raise ValueError(f"HDF5 superblock version {blob[8]} is not supported (only 0)")
        self.blob = blob
        self.so, self.sl = blob[13], blob[14]  # sizes of offsets and lengths
        if (self.so, self.sl) != (8, 8):
            raise ValueError("only 8-byte offsets and lengths are supported")
        self.base = self._u(24, 8)
        # the root group's symbol table entry follows the superblock's four addresses
        self.root = self._u(24 + 4 * 8 + 8, 8)

    def _u(self, pos: int, size: int) -> int:
        return int.from_bytes(self.blob[pos:pos + size], "little")

    # -- object headers -----------------------------------------------------
    def messages(self, addr: int) -> list[tuple[int, bytes]]:
        """(type, data) of every message of the v1 object header at addr."""
        addr += self.base
        if self.blob[addr] != 1:
            raise ValueError(f"object header version {self.blob[addr]} is not supported")
        count = self._u(addr + 2, 2)
        size = self._u(addr + 8, 4)
        blocks = [(addr + 16, size)]
        out = []
        while blocks and len(out) < count:
            pos, length = blocks.pop(0)
            end = pos + length
            while pos + 8 <= end and len(out) < count:
                mtype, msize = self._u(pos, 2), self._u(pos + 2, 2)
                data = self.blob[pos + 8:pos + 8 + msize]
                out.append((mtype, data))
                if mtype == 0x10:  # continuation
                    blocks.append((int.from_bytes(data[:8], "little") + self.base,
                                   int.from_bytes(data[8:16], "little")))
                pos += 8 + msize
        return out

    # -- groups ------------------------------------------------------------
    def children(self, header_addr: int) -> dict[str, int]:
        """name -> object header address of a symbol-table group's members."""
        for mtype, data in self.messages(header_addr):
            if mtype == 0x11:
                btree, heap = struct.unpack_from("<QQ", data)
                names = self._local_heap(heap)
                out = {}
                self._walk_btree(btree, names, out)
                return out
        raise ValueError("object is not a symbol-table group")

    def _local_heap(self, addr: int) -> int:
        pos = addr + self.base
        if self.blob[pos:pos + 4] != b"HEAP":
            raise ValueError("bad local heap signature")
        return self._u(pos + 24, 8) + self.base

    def _name(self, heap_data: int, offset: int) -> str:
        start = heap_data + offset
        return self.blob[start:self.blob.index(b"\0", start)].decode()

    def _walk_btree(self, addr: int, heap_data: int, out: dict) -> None:
        pos = addr + self.base
        if self.blob[pos:pos + 4] != b"TREE" or self.blob[pos + 4] != 0:
            raise ValueError("bad group B-tree node")
        level, used = self.blob[pos + 5], self._u(pos + 6, 2)
        cur = pos + 24 + 8  # after siblings and key 0
        for _ in range(used):
            child = self._u(cur, 8)
            if level > 0:
                self._walk_btree(child, heap_data, out)
            else:
                self._read_snod(child, heap_data, out)
            cur += 16  # child + next key
        return None

    def _read_snod(self, addr: int, heap_data: int, out: dict) -> None:
        pos = addr + self.base
        if self.blob[pos:pos + 4] != b"SNOD":
            raise ValueError("bad symbol table node")
        for i in range(self._u(pos + 6, 2)):
            entry = pos + 8 + 40 * i
            out[self._name(heap_data, self._u(entry, 8))] = self._u(entry + 8, 8)

    # -- datatypes, dataspaces, values ---------------------------------------
    @staticmethod
    def _dtype(data: bytes):
        cls, size = data[0] & 0x0F, int.from_bytes(data[4:8], "little")
        if cls == 1:
            if data[1] & 1:
                raise ValueError("big-endian data is not supported")
            return np.dtype(f"<f{size}")
        if cls == 3:
            return ("str", size)
        if cls == 9 and (data[1] & 0x0F) == 1:
            return ("vlen-str", size)
        raise ValueError(f"HDF5 datatype class {cls} is not supported")

    @staticmethod
    def _shape(data: bytes) -> tuple[int, ...]:
        version, rank = data[0], data[1]
        start = 8 if version == 1 else 4
        return tuple(int.from_bytes(data[start + 8 * i:start + 8 * i + 8], "little")
                     for i in range(rank))

    def _global_heap_object(self, addr: int, index: int) -> bytes:
        pos = addr + self.base
        if self.blob[pos:pos + 4] != b"GCOL":
            raise ValueError("bad global heap signature")
        end = pos + self._u(pos + 8, 8)
        cur = pos + 16
        while cur + 16 <= end:
            idx, size = self._u(cur, 2), self._u(cur + 8, 8)
            if idx == index:
                return self.blob[cur + 16:cur + 16 + size]
            if idx == 0:
                break
            cur += 16 + _pad8(size)
        raise ValueError(f"global heap object {index} not found")

    def attrs(self, header_addr: int) -> dict:
        out = {}
        for mtype, data in self.messages(header_addr):
            if mtype != 0x0C:
                continue
            version = data[0]
            nsz, tsz, ssz = struct.unpack_from("<HHH", data, 2)
            if version == 1:
                pos = 8
                name = data[pos:pos + nsz].rstrip(b"\0").decode()
                pos += _pad8(nsz)
                dtype = self._dtype(data[pos:pos + tsz])
                pos += _pad8(tsz)
                shape = self._shape(data[pos:pos + ssz])
                pos += _pad8(ssz)
            else:
                raise ValueError(f"attribute message version {version} is not supported")
            value = data[pos:]
            if isinstance(dtype, tuple) and dtype[0] == "vlen-str":
                if shape not in ((), (1,)):
                    raise ValueError("only scalar string attributes are supported")
                length, heap, index = struct.unpack_from("<IQI", value)
                out[name] = self._global_heap_object(heap, index)[:length].decode()
            elif isinstance(dtype, tuple):
                out[name] = value[:dtype[1]].rstrip(b"\0").decode()
            else:
                count = int(np.prod(shape)) if shape else 1
                out[name] = np.frombuffer(value, dtype, count).reshape(shape)
        return out

    def dataset(self, header_addr: int) -> np.ndarray:
        shape = dtype = layout = None
        for mtype, data in self.messages(header_addr):
            if mtype == 0x01:
                shape = self._shape(data)
            elif mtype == 0x03:
                dtype = self._dtype(data)
            elif mtype == 0x08:
                layout = data
            elif mtype == 0x0B:
                raise ValueError("filtered (compressed) datasets are not supported")
        if shape is None or dtype is None or layout is None or isinstance(dtype, tuple):
            raise ValueError("not a numeric dataset")
        if layout[0] != 3 or layout[1] != 1:
            raise ValueError(f"data layout v{layout[0]} class {layout[1]} is not supported "
                             "(only contiguous)")
        addr, size = struct.unpack_from("<QQ", layout, 2)
        count = int(np.prod(shape)) if shape else 1
        if addr == _UNDEF:
            return np.zeros(shape, dtype)
        if size != count * dtype.itemsize:
            raise ValueError("dataset size does not match its shape")
        return np.frombuffer(self.blob, dtype, count, addr + self.base).reshape(shape).copy()


class File:
    """``File(path)["/a/b/c"]`` -> numpy array; ``.attrs`` of the root group."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._r = _Reader(f.read())
        self.attrs = self._r.attrs(self._r.root)

    def _resolve(self, path: str) -> int:
        addr = self._r.root
        for part in path.strip("/").split("/"):
            members = self._r.children(addr)
            if part not in members:
                raise KeyError(path)
            addr = members[part]
        return addr

    def __getitem__(self, path: str) -> np.ndarray:
        return self._r.dataset(self._resolve(path))
