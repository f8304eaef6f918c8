"""OMERO.web session stores (≙ omero-ms-core's session stores).

The port's copy of the JAX package's ``services/sessions.py``.  The
reference decodes the OMERO.web Django session cookie and resolves it to an
``omero.session_key`` request attribute through a Redis or Postgres session
store (``ImageRegionMicroserviceVerticle.java:194-212``,
``config.yaml:29-42``).  With enforcement on (``session-store.required``,
the default for the redis and postgres stores) a cookie that does not
resolve is answered 403 before any handler runs; with it off (a static
store, or none) the request flows on anonymously and the ACL decides.

* :class:`StaticSessionStore`: a fixed mapping, or every cookie value
  passed through as the key (``accept_all``; the standalone posture);
* :class:`DjangoRedisSessionStore`: ``:1:django.contrib.sessions.cache
  <sid>`` entries as OMERO.web writes them (needs the ``redis`` package);
* :class:`DjangoPostgresSessionStore`: the ``django_session`` table, over
  ``asyncpg`` (else ``psycopg``) from a DSN, or over an already open
  :class:`~.db_metadata.AsyncDb` (:meth:`DjangoPostgresSessionStore.on_db`:
  the same SQL through any connection that has ``fetchrow``).
"""

from __future__ import annotations

import asyncio
import base64
import json
import pickle  # noqa: S403 (Django session payloads; a trusted store only)
from typing import Mapping, Optional, Protocol

DEFAULT_COOKIE = "sessionid"  # config.yaml:29-30 session-cookie-name


class SessionStore(Protocol):
    async def get_session_key(self, session_id: str) -> Optional[str]: ...


class StaticSessionStore:
    """A fixed cookie -> session-key mapping; ``accept_all`` passes the
    cookie value through as the session key."""

    def __init__(self, mapping: Optional[Mapping[str, str]] = None,
                 accept_all: bool = False):
        self.mapping = dict(mapping or {})
        self.accept_all = accept_all

    async def get_session_key(self, session_id: str) -> Optional[str]:
        if session_id in self.mapping:
            return self.mapping[session_id]
        return session_id if self.accept_all else None


def decode_django_session(payload: bytes) -> Optional[str]:
    """``omero.session_key`` (the connector's session key) out of a Django
    session payload: base64(hmac:pickle), else the JSON serializer's."""
    try:
        raw = base64.b64decode(payload)
        _, _, pickled = raw.partition(b":")
        data = pickle.loads(pickled)  # noqa: S301
    except Exception:
        try:
            data = json.loads(payload)
        except Exception:
            return None
    if not isinstance(data, dict):
        return None
    connector = data.get("connector")
    if isinstance(connector, dict):
        key = connector.get("omero_session_key")
        if key:
            return str(key)
    key = data.get("omero_session_key")
    return str(key) if key else None


class DjangoRedisSessionStore:
    """OMERO.web sessions out of Redis (≙ OmeroWebRedisSessionStore).
    Construction raises ImportError without the ``redis`` package."""

    def __init__(self, uri: str,
                 key_format: str = ":1:django.contrib.sessions.cache{0}"):
        import redis.asyncio as aioredis  # noqa: PLC0415
        self._client = aioredis.from_url(uri)
        self.key_format = key_format

    async def get_session_key(self, session_id: str) -> Optional[str]:
        payload = await self._client.get(self.key_format.format(session_id))
        if payload is None:
            return None
        return decode_django_session(payload)


class DjangoPostgresSessionStore:
    """OMERO.web sessions out of the ``django_session`` table (≙ omero-ms-
    core's ``OmeroWebJDBCSessionStore``): the cookie's row, if its
    ``expire_date`` is still ahead, decoded as the Redis store decodes.

    ``DjangoPostgresSessionStore(dsn)`` connects lazily through ``asyncpg``
    (else ``psycopg``) and raises ImportError without either, which the
    app factory turns into the JAX app's degrade-or-refuse;
    :meth:`on_db` runs the same SQL on an open connection."""

    _QUERY = ("SELECT session_data FROM django_session "
              "WHERE session_key = {ph} AND expire_date > now()")

    def __init__(self, dsn: str):
        try:
            import asyncpg  # noqa: PLC0415
            self._driver, self._module = "asyncpg", asyncpg
        except ImportError:
            import psycopg  # noqa: PLC0415
            self._driver, self._module = "psycopg", psycopg
        self._dsn = dsn
        self._pool = None
        self._init_lock = asyncio.Lock()

    @classmethod
    def on_db(cls, db) -> "DjangoPostgresSessionStore":
        """A store over an already open ``AsyncDb`` (``fetchrow``), which
        it does not close."""
        store = cls.__new__(cls)
        store._driver, store._module, store._dsn = "db", None, None
        store._pool = db
        store._init_lock = asyncio.Lock()
        return store

    async def _fetch(self, session_id: str) -> Optional[bytes]:
        if self._driver == "db":
            row = await self._pool.fetchrow(self._QUERY.format(ph="$1"),
                                            session_id)
            return None if row is None else row["session_data"]
        if self._driver == "asyncpg":
            if self._pool is None:
                async with self._init_lock:
                    if self._pool is None:    # no double create_pool
                        self._pool = await self._module.create_pool(
                            self._dsn, min_size=1, max_size=4)
            row = await self._pool.fetchrow(self._QUERY.format(ph="$1"),
                                            session_id)
            return None if row is None else row[0]
        # psycopg: one autocommit connection (a read-only lookup must not
        # sit idle in a transaction on django_session), opened again after
        # any failure; there is no pool to reconnect it.
        if self._pool is None:
            async with self._init_lock:
                if self._pool is None:
                    self._pool = await self._module.AsyncConnection.connect(
                        self._dsn, autocommit=True)
        try:
            async with self._pool.cursor() as cur:
                await cur.execute(self._QUERY.format(ph="%s"), (session_id,))
                row = await cur.fetchone()
        except Exception:
            conn, self._pool = self._pool, None
            try:
                await conn.close()
            except Exception:
                pass
            raise
        return None if row is None else row[0]

    async def get_session_key(self, session_id: str) -> Optional[str]:
        payload = await self._fetch(session_id)
        if payload is None:
            return None
        if isinstance(payload, str):
            payload = payload.encode()
        return decode_django_session(payload)

    async def close(self) -> None:
        """Close the store's own pool (an ``on_db`` connection is the
        caller's)."""
        if self._pool is not None and self._driver != "db":
            await self._pool.close()
            self._pool = None


async def resolve_session_key(store: Optional[SessionStore],
                              cookies: Mapping[str, str],
                              cookie_name: str = DEFAULT_COOKIE
                              ) -> Optional[str]:
    """Cookie jar -> OMERO session key (None when it does not resolve)."""
    if store is None:
        return None
    session_id = cookies.get(cookie_name)
    if not session_id:
        return None
    return await store.get_session_key(session_id)
