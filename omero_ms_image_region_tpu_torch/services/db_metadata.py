"""Metadata and ACL from the OMERO database.

The port's copy of the JAX package's ``services/db_metadata.py``.  The
reference's deployment resolves ``Pixels`` metadata, ``Mask`` shapes and
``canRead`` decisions from a live OMERO server and its PostgreSQL over the
clustered event bus (``ImageRegionRequestHandler.java:316-427``,
``ShapeMaskRequestHandler.java:223-277``).  :class:`DbMetadataService` is
that backend written directly against the OMERO relational schema: the
surface of ``services.metadata.LocalMetadataService``, reading the
``pixels`` / ``shape`` / ``session`` / ``experimentergroup`` tables, plus
:meth:`DbMetadataService.resolve_image_paths` (binary-repository paths).

It runs on a small async connection protocol (:class:`AsyncDb`:
``fetchrow`` / ``fetch``), so the SQL, the real content, is engine
portable: :meth:`PostgresMetadataService.connect` opens an ``asyncpg``
pool from a DSN; any other connection with the two calls serves as well
(a sqlite adapter that turns ``$N`` into ``?`` runs the same statements
over an OMERO-schema subset).

ACL (OMERO group permissions): an object row carries ``owner_id`` and
``group_id``; the group row carries the permissions long.  The owner reads
by the user-read bit, a member of the group by the group-read bit, anyone
else by the world-read bit; members of the ``system`` group (admins) read
everything.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Protocol, Sequence

from ..models.mask import Mask
from ..models.pixels import Pixels

# OMERO permissions-long read bits (ome.model.internal.Permissions), from
# the documented canonical values: private 'rw----' = -120 (0x88),
# group-read 'rwr---' = -56 (0xC8), read-annotate 'rwra--' = -40 (0xD8),
# read-write 'rwrw--' = -8 (0xF8), public-read 'rwr-r-' = -52 (0xCC).
USER_READ = 0x80
GROUP_READ = 0x40
WORLD_READ = 0x04


class AsyncDb(Protocol):
    """The slice of an asyncpg pool or connection these services use."""

    async def fetchrow(self, sql: str, *args: Any
                       ) -> Optional[Mapping[str, Any]]: ...

    async def fetch(self, sql: str, *args: Any
                    ) -> Sequence[Mapping[str, Any]]: ...


_SQL_PIXELS = """
SELECT p.sizex, p.sizey, p.sizez, p.sizec, p.sizet, pt.value AS pixels_type
FROM pixels p JOIN pixelstype pt ON p.pixelstype = pt.id
WHERE p.image = $1
"""

_SQL_IMAGE_ACL = """
SELECT i.owner_id, i.group_id, g.permissions
FROM image i JOIN experimentergroup g ON i.group_id = g.id
WHERE i.id = $1
"""

_SQL_SHAPE_ACL = """
SELECT s.owner_id, s.group_id, g.permissions
FROM shape s JOIN experimentergroup g ON s.group_id = g.id
WHERE s.id = $1
"""

_SQL_SESSION_USER = """
SELECT s.owner FROM session s WHERE s.uuid = $1 AND s.closed IS NULL
"""

_SQL_IS_MEMBER = """
SELECT 1 AS yes FROM groupexperimentermap m WHERE m.child = $1 AND m.parent = $2
"""

_SQL_IS_ADMIN = """
SELECT 1 AS yes FROM groupexperimentermap m
JOIN experimentergroup g ON m.parent = g.id
WHERE m.child = $1 AND g.name = 'system'
"""

_SQL_MASK = """
SELECT s.width, s.height, s.bytes, s.fillcolor
FROM shape s WHERE s.id = $1 AND s.bytes IS NOT NULL
"""

# Binary-repository resolution (the file-path resolver bean and
# Bio-Formats behind PixelsService.getPixelBuffer, beanRefContext.xml:13-21,
# ImageRegionRequestHandler.java:302-309): an OMERO 5 import lands in the
# ManagedRepository as the fileset's originalfile rows (path is
# repository-relative, name the file name).
_SQL_FILESET_FILES = """
SELECT f.path AS path, f.name AS name
FROM image i
JOIN filesetentry fe ON fe.fileset = i.fileset
JOIN originalfile f ON fe.originalfile = f.id
WHERE i.id = $1
ORDER BY fe.id
"""

# Images from before OMERO 5 have no fileset: their pixel data is the
# legacy ROMIO file <omero.data.dir>/Pixels/<pixels_id>.
_SQL_PIXELS_ID = """
SELECT p.id AS id FROM pixels p WHERE p.image = $1
"""


def _romio_rel_path(pixels_id: int) -> str:
    """The legacy ROMIO path of a pixels id, with the Dir-### fan-out of
    ``ome.io.nio.AbstractFileSystemService``: ids >= 1000 nest into
    3-digit-group directories, 1234 at ``Pixels/Dir-001/1234``, 1234567
    at ``Pixels/Dir-001/Dir-234/1234567``."""
    suffix = ""
    remaining = pixels_id
    while remaining > 999:
        remaining //= 1000
        if remaining > 0:
            suffix = f"/Dir-{remaining % 1000:03d}" + suffix
    return f"Pixels{suffix}/{pixels_id}"


def _unpack_fillcolor(value: Optional[int]):
    """OMERO stores a shape colour as one signed 32-bit RGBA int."""
    if value is None:
        return None
    v = value & 0xFFFFFFFF
    return ((v >> 24) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF)


class DbMetadataService:
    """The metadata service over an OMERO-schema database connection."""

    def __init__(self, db: AsyncDb):
        self.db = db

    async def get_pixels_description(self, image_id: int,
                                     session_key: Optional[str]
                                     ) -> Optional[Pixels]:
        if not await self.can_read("Image", image_id, session_key):
            return None
        row = await self.db.fetchrow(_SQL_PIXELS, image_id)
        if row is None:
            return None
        return Pixels(
            image_id=image_id,
            pixels_type=row["pixels_type"],
            size_x=int(row["sizex"]),
            size_y=int(row["sizey"]),
            size_z=int(row["sizez"]),
            size_c=int(row["sizec"]),
            size_t=int(row["sizet"]),
        )

    async def resolve_image_paths(self, image_id: int) -> list:
        """Repository-relative candidate paths of an image's pixel data:
        an OMERO 5 fileset's ManagedRepository files, else the legacy
        ``Pixels/<pixels_id>`` ROMIO file.  No ACL here: callers resolve
        paths only after ``can_read`` gated the request (the reference's
        resolver bean does not check permissions either)."""
        out = []
        for row in await self.db.fetch(_SQL_FILESET_FILES, image_id):
            path = (row["path"] or "").strip("/")
            name = (row["name"] or "").strip("/")
            if not name:
                continue
            rel = f"{path}/{name}" if path else name
            out.append(f"ManagedRepository/{rel}")
        if not out:
            row = await self.db.fetchrow(_SQL_PIXELS_ID, image_id)
            if row is not None:
                out.append(_romio_rel_path(int(row["id"])))
        return out

    async def _session_user(self, session_key: Optional[str]
                            ) -> Optional[int]:
        if session_key is None:
            return None
        row = await self.db.fetchrow(_SQL_SESSION_USER, session_key)
        return None if row is None else int(row["owner"])

    async def can_read(self, object_type: str, object_id: int,
                       session_key: Optional[str]) -> bool:
        """The read ACL of an ``Image`` or a ``Mask`` for a caller."""
        sql = _SQL_IMAGE_ACL if object_type == "Image" else _SQL_SHAPE_ACL
        row = await self.db.fetchrow(sql, object_id)
        if row is None:
            return False
        perms = int(row["permissions"])
        user = await self._session_user(session_key)
        if user is None:
            # Anonymous: only world-readable groups serve.
            return bool(perms & WORLD_READ)
        if user == int(row["owner_id"]):
            return bool(perms & USER_READ)
        if await self.db.fetchrow(_SQL_IS_ADMIN, user) is not None:
            return True
        if await self.db.fetchrow(
                _SQL_IS_MEMBER, user, int(row["group_id"])) is not None:
            return bool(perms & GROUP_READ)
        return bool(perms & WORLD_READ)

    async def get_mask(self, shape_id: int,
                       session_key: Optional[str]) -> Optional[Mask]:
        if not await self.can_read("Mask", shape_id, session_key):
            return None
        row = await self.db.fetchrow(_SQL_MASK, shape_id)
        if row is None:
            return None
        return Mask(
            shape_id=shape_id,
            width=int(row["width"]),
            height=int(row["height"]),
            bytes_=bytes(row["bytes"]),
            fill_color=_unpack_fillcolor(row["fillcolor"]),
        )


class PostgresMetadataService(DbMetadataService):
    """The asyncpg-backed service: :meth:`connect` opens a pool from a
    DSN and raises ImportError without ``asyncpg``, so the app can degrade
    as it does for the session stores."""

    def __init__(self, pool):
        super().__init__(pool)
        self._pool = pool

    @classmethod
    async def connect(cls, dsn: str, min_size: int = 1,
                      max_size: int = 4) -> "PostgresMetadataService":
        import asyncpg  # noqa: PLC0415 (ImportError: the caller degrades)

        pool = await asyncpg.create_pool(dsn, min_size=min_size,
                                         max_size=max_size)
        return cls(pool)

    async def close(self) -> None:
        await self._pool.close()
