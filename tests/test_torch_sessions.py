"""The port's session stores and session enforcement against the JAX
package's.

``decode_django_session`` gives the JAX answer for each payload form (the
pickle serializer's base64(hmac:pickle), the JSON serializer's, a key at
the top level, garbage, a non-dict, an empty connector).  The static store
and ``resolve_session_key`` answer alike.  The Postgres store runs over
``tests/torch_db_fixtures.py``'s sqlite ``django_session`` (the JAX store
through a stand-in ``asyncpg`` on the same database, the port's through
its ``AsyncDb`` constructor): a live cookie resolves to its OMERO session,
an expired row and an unknown cookie do not.  Both default apps with
``session-store: {type: postgres, required: true}`` answer the same 403s,
404s and 200s (status, body and cache headers) for the same cookies.
"""

import asyncio
import base64
import json
import pickle
import sys

import numpy as np
import pytest

from omero_ms_image_region_tpu.io.store import build_pyramid
from omero_ms_image_region_tpu.server.app import create_app as jax_app
from omero_ms_image_region_tpu.server.config import AppConfig as JaxConfig
from omero_ms_image_region_tpu.services import sessions as jax_sessions
from omero_ms_image_region_tpu_torch.server.app import create_app
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.services import sessions

from torch_db_fixtures import (COOKIES, EXPIRED_COOKIE, fake_asyncpg,
                               seeded_db)
from torch_workload_apps import cache_headers


def run(coro):
    return asyncio.run(coro)


PAYLOADS = [
    base64.b64encode(b"hmac:" + pickle.dumps(
        {"connector": {"omero_session_key": "pk"}})),
    json.dumps({"connector": {"omero_session_key": "abc123"}}).encode(),
    json.dumps({"omero_session_key": "top"}).encode(),
    json.dumps({"connector": {}}).encode(),
    json.dumps(["not", "a", "dict"]).encode(),
    base64.b64encode(b"hmac:" + pickle.dumps({"connector": None})),
    b"garbage!!",
    b"",
]


@pytest.mark.parametrize("payload", PAYLOADS)
def test_decode_django_session_as_jax(payload):
    assert (sessions.decode_django_session(payload)
            == jax_sessions.decode_django_session(payload))


def test_static_store_and_cookie_resolution_as_jax():
    for mod in (jax_sessions, sessions):
        store = mod.StaticSessionStore({"cookie1": "omero-key-1"})
        assert run(store.get_session_key("cookie1")) == "omero-key-1"
        assert run(store.get_session_key("other")) is None
        assert run(mod.StaticSessionStore(accept_all=True)
                   .get_session_key("x")) == "x"
        assert run(mod.resolve_session_key(
            store, {"sessionid": "cookie1"})) == "omero-key-1"
        assert run(mod.resolve_session_key(store, {})) is None
        assert run(mod.resolve_session_key(None, {"sessionid": "x"})) \
            is None


def test_postgres_stores_resolve_alike(monkeypatch):
    db = seeded_db()
    monkeypatch.setitem(sys.modules, "asyncpg", fake_asyncpg(db))
    jax_store = jax_sessions.DjangoPostgresSessionStore("postgresql://h")
    port_store = sessions.DjangoPostgresSessionStore.on_db(db)
    cookies = [*COOKIES, EXPIRED_COOKIE, "ck-unknown"]

    async def resolve(store):
        return [await store.get_session_key(c) for c in cookies]

    want = run(resolve(jax_store))
    assert want == [*COOKIES.values(), None, None]
    assert run(resolve(port_store)) == want


# ---------------------------------------------------------- both apps

PRIVATE_IMG, PUBLIC_IMG = 7, 8
RAW = {"session-store": {"type": "postgres", "uri": "postgresql://h/omero",
                         "required": True}}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("sessions")
    rng = np.random.default_rng(5)
    for image in (PRIVATE_IMG, PUBLIC_IMG):
        planes = rng.integers(0, 60000, (2, 1, 64, 64)).astype(np.uint16)
        build_pyramid(planes, str(root / str(image)), chunk=(64, 64),
                      n_levels=1)
    (root / str(PRIVATE_IMG) / "acl.json").write_text(
        json.dumps({"sessions": ["sess-owner"]}))
    return str(root)


def test_default_apps_enforce_sessions_alike(data_dir, monkeypatch):
    from aiohttp.test_utils import TestClient, TestServer

    db = seeded_db()
    monkeypatch.setitem(sys.modules, "asyncpg", fake_asyncpg(db))
    raw = dict(RAW, **{"data-dir": data_dir})
    query = "?tile=0,0,0,32,32&c=1|0:60000$FF0000,2|0:60000$00FF00&m=c"
    requests = []
    for image in (PRIVATE_IMG, PUBLIC_IMG):
        for cookie in (*COOKIES, EXPIRED_COOKIE, "ck-unknown", None):
            for fmt in ("png", "jpeg"):
                requests.append((image, cookie, fmt))

    async def through(app):
        out = []
        async with TestClient(TestServer(app)) as client:
            for image, cookie, fmt in requests:
                headers = {"Cookie": f"sessionid={cookie}"} if cookie else {}
                r = await client.get(
                    f"/webgateway/render_image_region/{image}/0/0"
                    f"{query}&format={fmt}", headers=headers)
                out.append((r.status, await r.read(),
                            cache_headers(r.headers)))
        return out

    jax = run(through(jax_app(JaxConfig.from_dict(dict(raw)))))
    port = run(through(create_app(AppConfig.from_dict(dict(raw)), "cpu",
                                  db=db)))
    statuses = {}
    for (image, cookie, fmt), want, got in zip(requests, jax, port):
        assert got == want, (image, cookie, fmt)
        statuses[(image, cookie)] = got[0]
    for cookie in (EXPIRED_COOKIE, "ck-unknown", None):
        assert statuses[(PUBLIC_IMG, cookie)] == 403
    assert statuses[(PRIVATE_IMG, "ck-owner")] == 200
    assert statuses[(PRIVATE_IMG, "ck-labmate")] == 404
    assert statuses[(PUBLIC_IMG, "ck-outsider")] == 200
