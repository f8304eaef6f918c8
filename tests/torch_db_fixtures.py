"""An OMERO-schema subset in sqlite, for the port's database-backed
services and their JAX counterparts.

The seed is the JAX package's own (``tests/test_db_metadata.py``: groups
with the canonical permission longs -120, -56 and -52, an owner, a labmate,
an outsider and an admin, their sessions, private, group-read and public
images, a fileset image in the ManagedRepository and a pre-FS image, two
masks), plus a ``django_session`` table whose rows map OMERO.web cookies to
those sessions (one of them expired).

:class:`SqliteDb` is an ``AsyncDb`` (``fetchrow`` / ``fetch``) over it: it
turns ``$N`` placeholders into ``?`` and ``now()`` into
``CURRENT_TIMESTAMP``, so the services' PostgreSQL statements run as
written, and counts the statements it ran.  :func:`fake_asyncpg` is a
stand-in ``asyncpg`` module whose pool runs on the same database, for the
JAX session store, which connects through ``asyncpg``.
"""

import base64
import pickle
import re
import sqlite3
import types

import numpy as np

# Canonical OMERO permission longs (ome.model.internal.Permissions).
PRIVATE = -120        # rw----
GROUP_RO = -56        # rwr---
PUBLIC_RO = -52       # rwr-r-

SCHEMA = """
CREATE TABLE experimentergroup (
    id INTEGER PRIMARY KEY, name TEXT, permissions INTEGER);
CREATE TABLE experimenter (id INTEGER PRIMARY KEY, omename TEXT);
CREATE TABLE groupexperimentermap (child INTEGER, parent INTEGER);
CREATE TABLE session (
    id INTEGER PRIMARY KEY, uuid TEXT, owner INTEGER, closed TEXT);
CREATE TABLE image (
    id INTEGER PRIMARY KEY, owner_id INTEGER, group_id INTEGER,
    fileset INTEGER);
CREATE TABLE fileset (id INTEGER PRIMARY KEY, templateprefix TEXT);
CREATE TABLE filesetentry (
    id INTEGER PRIMARY KEY, fileset INTEGER, originalfile INTEGER,
    clientpath TEXT);
CREATE TABLE originalfile (
    id INTEGER PRIMARY KEY, path TEXT, name TEXT, mimetype TEXT);
CREATE TABLE pixelstype (id INTEGER PRIMARY KEY, value TEXT);
CREATE TABLE pixels (
    id INTEGER PRIMARY KEY, image INTEGER, sizex INTEGER, sizey INTEGER,
    sizez INTEGER, sizec INTEGER, sizet INTEGER, pixelstype INTEGER);
CREATE TABLE roi (id INTEGER PRIMARY KEY, image INTEGER);
CREATE TABLE shape (
    id INTEGER PRIMARY KEY, roi INTEGER, owner_id INTEGER,
    group_id INTEGER, width INTEGER, height INTEGER, bytes BLOB,
    fillcolor INTEGER);
CREATE TABLE django_session (
    session_key TEXT PRIMARY KEY, session_data TEXT, expire_date TEXT);
"""

MASK_BITS = np.packbits(
    np.tile([1, 0], 16 * 8 // 2).astype(np.uint8)).tobytes()

SESSIONS = ("sess-owner", "sess-labmate", "sess-outsider", "sess-root")
# OMERO.web cookie -> the OMERO session its Django session holds.
COOKIES = {"ck-owner": "sess-owner", "ck-labmate": "sess-labmate",
           "ck-outsider": "sess-outsider", "ck-root": "sess-root"}
EXPIRED_COOKIE = "ck-expired"


def django_payload(omero_key: str, form: str = "pickle") -> str:
    """A ``django_session.session_data`` value holding ``omero_key`` in
    OMERO.web's connector: the pickle serializer's base64(hmac:pickle), or
    the JSON serializer's text."""
    doc = {"connector": {"omero_session_key": omero_key}}
    if form == "json":
        import json
        return json.dumps(doc)
    return base64.b64encode(b"hmac:" + pickle.dumps(doc)).decode()


def seed(conn: sqlite3.Connection) -> None:
    """The JAX tests' OMERO rows, and the Django sessions."""
    conn.executescript(SCHEMA)
    conn.executemany(
        "INSERT INTO experimentergroup VALUES (?, ?, ?)",
        [(0, "system", PRIVATE), (10, "lab-private", PRIVATE),
         (11, "lab-shared", GROUP_RO), (12, "atlas-public", PUBLIC_RO)])
    conn.executemany(
        "INSERT INTO experimenter VALUES (?, ?)",
        [(100, "owner"), (101, "labmate"), (102, "outsider"),
         (103, "root")])
    conn.executemany(
        "INSERT INTO groupexperimentermap VALUES (?, ?)",
        [(100, 10), (100, 11), (100, 12), (101, 10), (101, 11),
         (102, 12), (103, 0)])
    conn.executemany(
        "INSERT INTO session VALUES (?, ?, ?, ?)",
        [(1, "sess-owner", 100, None), (2, "sess-labmate", 101, None),
         (3, "sess-outsider", 102, None), (4, "sess-root", 103, None),
         (5, "sess-closed", 100, "2026-01-01 00:00:00")])
    conn.executemany(
        "INSERT INTO image VALUES (?, ?, ?, ?)",
        [(1, 100, 10, None),   # private image
         (2, 100, 11, None),   # group-readable image
         (3, 100, 12, None),   # world-readable image
         (4, 100, 12, 900),    # fileset-backed (ManagedRepository)
         (5, 100, 12, None)])  # pre-FS (legacy Pixels file)
    conn.execute("INSERT INTO fileset VALUES (900, 'demo_2/2026-07/31/')")
    conn.executemany(
        "INSERT INTO filesetentry VALUES (?, ?, ?, ?)",
        [(1, 900, 800, "a.fake"), (2, 900, 801, "img.ome.tiff")])
    conn.executemany(
        "INSERT INTO originalfile VALUES (?, ?, ?, ?)",
        [(800, "demo_2/2026-07/31/", "a.fake", "application/x-fake"),
         (801, "demo_2/2026-07/31/", "img.ome.tiff", "image/tiff")])
    conn.execute("INSERT INTO pixelstype VALUES (1, 'uint16')")
    conn.execute("INSERT INTO pixelstype VALUES (2, 'uint8')")
    conn.executemany(
        "INSERT INTO pixels VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
        [(50, 1, 4096, 4096, 16, 4, 1, 1), (51, 2, 512, 256, 1, 3, 1, 2),
         (52, 4, 96, 64, 1, 2, 1, 1), (53, 5, 48, 32, 2, 1, 1, 1)])
    conn.execute("INSERT INTO roi VALUES (7, 2)")
    # A mask on the group-readable image (fill RGBA 0x00FF00FF), and one
    # without a fill in the private group.
    conn.execute("INSERT INTO shape VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                 (70, 7, 100, 11, 16, 8, MASK_BITS, 0x00FF00FF))
    conn.execute("INSERT INTO shape VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                 (71, 7, 100, 10, 16, 8, MASK_BITS, None))
    rows = [(cookie, django_payload(key,
                                    "json" if cookie == "ck-root"
                                    else "pickle"),
             "2999-01-01 00:00:00") for cookie, key in COOKIES.items()]
    rows.append((EXPIRED_COOKIE, django_payload("sess-owner"),
                 "2001-01-01 00:00:00"))
    conn.executemany("INSERT INTO django_session VALUES (?, ?, ?)", rows)
    conn.commit()


def translate(sql: str) -> str:
    """PostgreSQL statement -> sqlite: ``$N`` -> ``?``, ``now()`` ->
    ``CURRENT_TIMESTAMP``."""
    return re.sub(r"\$\d+", "?", sql).replace("now()", "CURRENT_TIMESTAMP")


class SqliteDb:
    """``AsyncDb`` over sqlite, counting the statements it ran."""

    def __init__(self, conn: sqlite3.Connection):
        conn.row_factory = sqlite3.Row
        self.conn = conn
        self.statements = 0

    async def fetchrow(self, sql: str, *args):
        self.statements += 1
        row = self.conn.execute(translate(sql), args).fetchone()
        return None if row is None else dict(row)

    async def fetch(self, sql: str, *args):
        self.statements += 1
        return [dict(r) for r in
                self.conn.execute(translate(sql), args).fetchall()]


def seeded_db(path: str = ":memory:") -> SqliteDb:
    conn = sqlite3.connect(path, check_same_thread=False)
    seed(conn)
    return SqliteDb(conn)


def fake_asyncpg(db: SqliteDb) -> types.ModuleType:
    """An ``asyncpg`` stand-in whose ``create_pool`` returns a pool on
    ``db`` (``fetchrow`` / ``fetch``; rows support ``row[0]`` and
    ``row["name"]`` as asyncpg's records do)."""

    class Pool:
        async def fetchrow(self, sql, *args):
            db.statements += 1
            return db.conn.execute(translate(sql), args).fetchone()

        async def fetch(self, sql, *args):
            db.statements += 1
            return db.conn.execute(translate(sql), args).fetchall()

        async def close(self):
            pass

    module = types.ModuleType("asyncpg")

    async def create_pool(dsn, **kw):
        return Pool()

    module.create_pool = create_pool
    return module
