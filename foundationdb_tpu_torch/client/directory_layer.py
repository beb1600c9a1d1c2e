"""Directory layer: hierarchical named directories over short allocated
prefixes (bindings/python/fdb/directory_impl.py semantics).

A directory maps a path like ("app", "users") to a short, stable key
prefix allocated once and recorded IN the database, so layers get human
paths without paying path-length keys on every row.  Supported surface
(the reference layer's core): create_or_open / open / create, list,
remove, move, exists — all transactional.

Metadata model (simplified vs the reference's node subtree + HCA, same
observable semantics):

  <node>("alloc",)          -> next prefix counter (OCC read-modify-write)
  <node>("d", *path)        -> the allocated prefix for `path`

Prefixes come from a counter encoded through the tuple layer, so they are
compact and never collide.  Allocation contention is serialized by OCC on
the counter key (the reference's high-contention allocator exists to
spread this load; this layer trades that optimization for simplicity and
keeps the API).

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .tuple_layer import Subspace, pack


class Directory(Subspace):
    """An opened directory: a Subspace rooted at its allocated prefix."""

    def __init__(self, layer: "DirectoryLayer", path: tuple, prefix: bytes) -> None:
        super().__init__((), prefix)
        self._layer = layer
        self.path = path

    async def list(self, tr) -> list[str]:
        return await self._layer.list(tr, self.path)

    async def remove(self, tr) -> None:
        await self._layer.remove(tr, self.path)


class DirectoryLayer:
    def __init__(self, node_prefix: bytes = b"\xfe") -> None:
        self._node = Subspace((), node_prefix)
        self._alloc_key = self._node.pack(("alloc",))

    def _meta_key(self, path: tuple) -> bytes:
        return self._node.pack(("d",) + tuple(path))

    @staticmethod
    def _require_ryw(tr) -> None:
        """The allocator and parent-creation logic read their own writes
        (two allocations in one transaction must see each other's counter
        bump), so only RYW transactions — db.run's default — are safe."""
        from .ryw import ReadYourWritesTransaction

        if not isinstance(tr, ReadYourWritesTransaction):
            raise TypeError(
                "DirectoryLayer requires a read-your-writes transaction "
                "(use db.run(fn) or db.create_ryw_transaction())"
            )

    @staticmethod
    def _check_path(path: tuple) -> tuple:
        path = tuple(path)
        if not path:
            raise ValueError("directory path must be non-empty")
        return path

    async def _allocate_prefix(self, tr) -> bytes:
        raw = await tr.get(self._alloc_key)
        n = int(raw) if raw is not None else 0
        tr.set(self._alloc_key, b"%d" % (n + 1))
        # content prefixes live under \xfd, disjoint from user keys and from
        # the \xfe node metadata
        return b"\xfd" + pack((n,))

    async def create_or_open(self, tr, path) -> Directory:
        self._require_ryw(tr)
        path = self._check_path(path)
        # parents must exist first (the reference auto-creates them)
        for i in range(1, len(path)):
            await self._create_one(tr, path[:i], must_create=False)
        prefix = await self._create_one(tr, path, must_create=False)
        return Directory(self, path, prefix)

    async def create(self, tr, path) -> Directory:
        self._require_ryw(tr)
        path = self._check_path(path)
        for i in range(1, len(path)):
            await self._create_one(tr, path[:i], must_create=False)
        prefix = await self._create_one(tr, path, must_create=True)
        return Directory(self, path, prefix)

    async def open(self, tr, path) -> Directory:
        path = self._check_path(path)
        raw = await tr.get(self._meta_key(path))
        if raw is None:
            raise KeyError(f"directory {path!r} does not exist")
        return Directory(self, path, raw)

    async def exists(self, tr, path) -> bool:
        return await tr.get(self._meta_key(tuple(path))) is not None

    async def _create_one(self, tr, path: tuple, must_create: bool) -> bytes:
        raw = await tr.get(self._meta_key(path))
        if raw is not None:
            if must_create:
                raise KeyError(f"directory {path!r} already exists")
            return raw
        prefix = await self._allocate_prefix(tr)
        tr.set(self._meta_key(path), prefix)
        return prefix

    async def list(self, tr, path=()) -> list[str]:
        """Immediate child names of `path`."""
        path = tuple(path)
        base = self._node.pack(("d",) + path)
        # children are tuples one element longer; grandchildren sort inside
        # their child's range and are filtered by arity
        out = []
        rows = await tr.get_range(base + b"\x00", base + b"\xff")
        seen = set()
        for k, _v in rows:
            sub = self._node.unpack(k)[1 + len(path):]
            if sub and sub[0] not in seen:
                seen.add(sub[0])
                out.append(sub[0])
        return out

    async def remove(self, tr, path) -> None:
        """Delete the directory, its subdirectories, and ALL content."""
        path = self._check_path(path)
        raw = await tr.get(self._meta_key(path))
        if raw is None:
            raise KeyError(f"directory {path!r} does not exist")
        # content of this dir and every subdirectory
        prefixes = [raw]
        base = self._node.pack(("d",) + path)
        rows = await tr.get_range(base + b"\x00", base + b"\xff")
        prefixes += [v for _k, v in rows]
        for p in prefixes:
            tr.clear_range(p, p + b"\xff")
        tr.clear_range(base, base + b"\xff")
        tr.clear(self._meta_key(path))

    async def move(self, tr, old_path, new_path) -> Directory:
        """Rename a directory subtree; allocated prefixes (and therefore all
        content keys) are untouched — only the metadata moves."""
        self._require_ryw(tr)
        old_path = self._check_path(old_path)
        new_path = self._check_path(new_path)
        if new_path[: len(old_path)] == old_path:
            raise ValueError("cannot move a directory into its own subtree")
        raw = await tr.get(self._meta_key(old_path))
        if raw is None:
            raise KeyError(f"directory {old_path!r} does not exist")
        if await tr.get(self._meta_key(new_path)) is not None:
            raise KeyError(f"directory {new_path!r} already exists")
        for i in range(1, len(new_path)):
            await self._create_one(tr, new_path[:i], must_create=False)
        # re-key the whole metadata subtree
        base = self._node.pack(("d",) + old_path)
        rows = await tr.get_range(base + b"\x00", base + b"\xff")
        moves = [(old_path, raw)] + [
            (self._node.unpack(k)[1:], v) for k, v in rows
        ]
        for sub_path, prefix in moves:
            sub_path = tuple(sub_path)
            suffix = sub_path[len(old_path):]
            tr.clear(self._meta_key(sub_path))
            tr.set(self._meta_key(new_path + suffix), prefix)
        return Directory(self, new_path, raw)
