"""A reader and a writer for the HDF5 subset that keras-style NIF weights use.

The port does not depend on h5py: the NIF loader reads
``converted.hdf5`` with this numpy-only reader, and ``NifWeights.save_h5``
writes it with ``write``.  The reader covers what h5py writes with its
default ("earliest") file format: superblock version 0, version-1 object
headers (with continuation blocks), groups as symbol tables (v1 B-trees,
SNOD nodes, local heaps), contiguous datasets of fixed-size little-endian
floats, and attributes whose values are fixed or variable-length strings
(the latter in global heap collections).  Anything else raises ValueError
naming what it met.  The writer emits the same subset (fixed-length
string attributes on the root group, f16 and f32 datasets), laid out as
h5py's earliest format lays it out, so h5py and the HDF5 library read it.
"""

from __future__ import annotations

import os
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


# -- the writer ---------------------------------------------------------------

_LEAF_K, _NODE_K = 4, 16  # the superblock's group leaf and internal node K (h5py's)
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40  # an SNOD holds up to 2K symbol table entries
_TREE_SIZE = 24 + 2 * _NODE_K * 8 + (2 * _NODE_K + 1) * 8  # 2K children, 2K + 1 keys
# IEEE float datatype properties by size: (exponent location, exponent size,
# mantissa size, exponent bias); the sign bit is the top bit.
_FLOATS = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127)}


def _float_type(dtype: np.dtype) -> bytes:
    """Datatype message of a little-endian IEEE float (class 1, version 1)."""
    size = dtype.itemsize
    if dtype.kind != "f" or size not in _FLOATS or dtype.byteorder == ">":
        raise ValueError(f"only little-endian f16 and f32 datasets can be written, got {dtype}")
    eloc, esize, msize, bias = _FLOATS[size]
    # bit field: mantissa normalisation 2 (implied leading 1), sign at the top bit
    return (bytes([0x11, 0x20, 8 * size - 1, 0]) + struct.pack("<I", size)
            + struct.pack("<HHBBBBI", 0, 8 * size, eloc, esize, 0, msize, bias))


def _string_type(size: int) -> bytes:
    """Fixed-length ASCII string, null-padded (class 3, version 1)."""
    return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", size)


def _space(shape: tuple[int, ...]) -> bytes:
    """Dataspace message version 1 with the maximum dims (h5py's form);
    rank 0 is a scalar."""
    flags = 1 if shape else 0
    dims = b"".join(struct.pack("<Q", d) for d in shape)
    return bytes([1, len(shape), flags, 0, 0, 0, 0, 0]) + dims + (dims if shape else b"")


def _message(mtype: int, data: bytes) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    if len(data) > 0xFFFF:
        raise ValueError("an object header message is limited to 64 KiB")
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


class _Writer:
    def __init__(self):
        self.blob = bytearray(96)  # the superblock

    def alloc(self, size: int) -> int:
        """An 8-byte aligned block of zeros at the end of the file."""
        addr = _pad8(len(self.blob))
        self.blob.extend(b"\0" * (addr + size - len(self.blob)))
        return addr

    def put(self, addr: int, data: bytes) -> None:
        self.blob[addr:addr + len(data)] = data

    def header(self, messages: list[bytes]) -> int:
        """A version-1 object header holding ``messages`` in one chunk."""
        body = b"".join(messages)
        addr = self.alloc(16 + len(body))
        self.put(addr, struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body)
        return addr

    def dataset(self, arr: np.ndarray) -> int:
        if arr.ndim == 0:
            raise ValueError("only datasets of rank 1 or more can be written")
        arr = np.ascontiguousarray(arr)
        dtype = arr.dtype.newbyteorder("<")
        raw = arr.astype(dtype, copy=False).tobytes()
        data = self.alloc(len(raw)) if raw else _UNDEF
        if raw:
            self.put(data, raw)
        return self.header([
            _message(0x01, _space(arr.shape)),
            _message(0x03, _float_type(dtype)),
            _message(0x05, bytes([2, 2, 2, 1, 0, 0, 0, 0])),  # fill value: default, never
            _message(0x08, struct.pack("<BBQQ", 3, 1, data, len(raw))),  # contiguous
        ])

    def group(self, members: dict, attrs: dict[str, str] | None = None) -> tuple[int, int, int]:
        """A symbol-table group of ``members`` (name -> ndarray or a dict of
        members) -> (object header, B-tree, local heap) addresses."""
        names = sorted(members, key=lambda n: n.encode())  # strcmp order
        if len(names) > 2 * _LEAF_K * 2 * _NODE_K:
            raise ValueError(f"a group of more than {4 * _LEAF_K * _NODE_K} members")
        entries = []  # (name offset in the heap, object header, cache type, scratch)
        heap = bytearray(8)  # offset 0: the empty name (key 0 of the B-tree)
        for name in names:
            raw = name.encode()
            if not raw or b"/" in raw or b"\0" in raw:
                raise ValueError(f"bad HDF5 link name {name!r}")
            offset = len(heap)
            heap += raw + b"\0" * (_pad8(len(raw) + 1) - len(raw))
            child = members[name]
            if isinstance(child, dict):
                header, tree, lheap = self.group(child)
                entries.append((offset, header, 1, struct.pack("<QQ", tree, lheap)))
            else:
                entries.append((offset, self.dataset(child), 0, b"\0" * 16))
        nodes = [entries[i:i + 2 * _LEAF_K] for i in range(0, len(entries), 2 * _LEAF_K)]
        tree = self.alloc(_TREE_SIZE)
        keys_children = bytearray(struct.pack("<Q", 0))
        for node in nodes:
            snod = self.alloc(_SNOD_SIZE)
            self.put(snod, b"SNOD" + struct.pack("<BBH", 1, 0, len(node)) + b"".join(
                struct.pack("<QQI4x", off, hdr, cache) + scratch
                for off, hdr, cache, scratch in node))
            keys_children += struct.pack("<QQ", snod, node[-1][0])  # key: its last name
        self.put(tree, b"TREE" + struct.pack("<BBHQQ", 0, 0, len(nodes), _UNDEF, _UNDEF)
                 + keys_children)
        lheap = self.alloc(32 + len(heap))
        # no free block: the free list's head is H5HL_FREE_NULL (1)
        self.put(lheap, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, lheap + 32)
                 + bytes(heap))
        messages = [_message(0x11, struct.pack("<QQ", tree, lheap))]
        for name, value in (attrs or {}).items():
            raw_name = name.encode() + b"\0"
            raw = value.encode("ascii")
            dtype, space = _string_type(max(1, len(raw))), _space(())
            messages.append(_message(0x0C, struct.pack("<BBHHH", 1, 0, len(raw_name),
                                                       len(dtype), len(space))
                                     + b"".join(p + b"\0" * (_pad8(len(p)) - len(p))
                                                for p in (raw_name, dtype, space))
                                     + (raw or b"\0")))
        return self.header(messages), tree, lheap


def write(path: str, attrs: dict[str, str], datasets: dict[str, np.ndarray]) -> None:
    """Write ``datasets`` ("/group/.../name" -> little-endian float array)
    and the root group's string ``attrs`` as an HDF5 file of the subset
    above: superblock v0, v1 object headers, symbol-table groups whose
    B-tree and SNOD entries are sorted by name, contiguous datasets."""
    tree: dict = {}
    for key, arr in datasets.items():
        parts = key.strip("/").split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"{key!r}: {part!r} is a dataset, not a group")
        if parts[-1] in node:
            raise ValueError(f"{key!r} is given twice or is a group")
        node[parts[-1]] = np.asarray(arr)
    w = _Writer()
    root, btree, lheap = w.group(tree, attrs)
    w.put(0, _SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
          + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
          + struct.pack("<QQQQ", 0, _UNDEF, len(w.blob), _UNDEF)
          # the root group's symbol table entry, its B-tree and heap cached
          + struct.pack("<QQI4xQQ", 0, root, 1, btree, lheap))
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(w.blob)
    os.replace(tmp, path)
