"""PyTorch port, auth: the same guarded app in ``gofr_tpu`` and in
``gofr_tpu_torch`` (HTTP Basic, API keys, their validator forms, OAuth
bearer tokens verified against a JWKS document served on a free local
port, a caller's decoder, and ``ctx.get_auth_info()``), driven with the
same requests: the same status and body each time. Then
``verify_rs256`` and ``JWKSProvider`` of both packages on the same
tokens (valid, expired, not yet valid, bad signature, tampered, another
key's, ``alg: none``, malformed; a rotated-out ``kid`` through the
provider): the same claims or the same
exception text. The port's twins of ``tests/test_jwks.py`` and of the
auth tests of ``tests/test_http_app.py``.
"""

import asyncio
import base64
import hashlib
import http.server
import importlib
import json
import random
import threading
import time

import pytest

pytestmark = pytest.mark.timeout(120)

PKGS = ("gofr_tpu", "gofr_tpu_torch")
NOW = 1_700_000_000.0


def _is_probable_prime(n: int, rng: random.Random, rounds: int = 20) -> bool:
    if n < 4:
        return n in (2, 3)
    if n % 2 == 0:
        return False
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 2), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _gen_prime(bits: int, rng: random.Random) -> int:
    while True:
        c = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(c, rng):
            return c


def b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


# the DER prefix of SHA-256's DigestInfo (RFC 8017)
SHA256_PREFIX = bytes.fromhex("3031300d060960864801650304020105000420")


class RSAKey:
    """A test-only RSA key (1024 bits, seeded) that signs RS256 JWTs."""

    def __init__(self, seed: int) -> None:
        rng = random.Random(seed)
        p, q = _gen_prime(512, rng), _gen_prime(512, rng)
        self.n, self.e = p * q, 65537
        self.d = pow(self.e, -1, (p - 1) * (q - 1))

    def sign_jwt(self, claims: dict, kid: str = "k1", alg: str = "RS256"
                 ) -> str:
        header = b64(json.dumps({"alg": alg, "kid": kid}).encode())
        payload = b64(json.dumps(claims).encode())
        digest = hashlib.sha256(f"{header}.{payload}".encode()).digest()
        k = (self.n.bit_length() + 7) // 8
        t = SHA256_PREFIX + digest
        em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
        sig = pow(int.from_bytes(em, "big"), self.d, self.n).to_bytes(k,
                                                                     "big")
        return f"{header}.{payload}.{b64(sig)}"

    def jwk(self, kid: str = "k1") -> dict:
        def b64i(v: int) -> str:
            return b64(v.to_bytes((v.bit_length() + 7) // 8, "big"))

        return {"kty": "RSA", "kid": kid, "use": "sig", "n": b64i(self.n),
                "e": b64i(self.e)}


@pytest.fixture(scope="module")
def keys():
    return RSAKey(42), RSAKey(43)


def tokens(keys) -> dict:
    k1, k2 = keys
    good = k1.sign_jwt({"sub": "ada", "exp": NOW + 60})
    h, p, s = good.split(".")
    return {
        "valid": good,
        "no_exp": k1.sign_jwt({"sub": "bob", "roles": ["a", "b"]}),
        "expired": k1.sign_jwt({"sub": "ada", "exp": NOW - 10}),
        "not_yet_valid": k1.sign_jwt({"sub": "ada", "nbf": NOW + 60}),
        "bad_signature": good[:-6] + "AAAAAA",
        "tampered": f"{h}.{b64(json.dumps({'sub': 'mallory'}).encode())}.{s}",
        "wrong_key": k2.sign_jwt({"sub": "ada"}, kid="k1"),
        "alg_none": (f"{b64(json.dumps({'alg': 'none'}).encode())}."
                     f"{b64(json.dumps({'sub': 'x'}).encode())}."),
        "malformed": "abc.def",
        "short_sig": f"{h}.{p}.{b64(b'xx')}",
    }


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("case", ["valid", "no_exp", "expired",
                                  "not_yet_valid", "bad_signature",
                                  "tampered", "wrong_key", "alg_none",
                                  "malformed", "short_sig"])
def test_verify_rs256_same_claims_or_same_error(keys, case):
    token = tokens(keys)[case]
    got = [outcome(lambda m=importlib.import_module(f"{pkg}.http.jwks"):
                   m.verify_rs256(token, keys[0].n, keys[0].e, now=NOW))
           for pkg in PKGS]
    assert got[1] == got[0]
    if case in ("valid", "no_exp"):
        assert got[1][0] == "ok"
    else:
        assert got[1][0] == "JWKSError"


def test_provider_caches_rotates_and_refuses_the_same(keys, run):
    """A JWKS document that rotates from k1 to k2: both providers fetch
    the same number of times and give the same answers."""
    k1, k2 = keys

    async def scenario(pkg):
        fetches = []

        def fetcher(url):
            fetches.append(url)
            return ({"keys": [k1.jwk("k1")]} if len(fetches) == 1
                    else {"keys": [k2.jwk("k2")]})

        jwks = importlib.import_module(f"{pkg}.http.jwks")
        p = jwks.JWKSProvider("http://jwks.test/keys", fetcher=fetcher)
        t1 = k1.sign_jwt({"sub": "a"}, kid="k1")
        t2 = k2.sign_jwt({"sub": "b"}, kid="k2")
        out = []
        for token in (t1, t1, t2, t1, "garbage"):
            try:
                out.append(("ok", await p.verify(token), len(fetches)))
            except jwks.JWKSError as exc:
                out.append(("error", str(exc), len(fetches)))
        return out

    jax, port = (run(scenario(pkg)) for pkg in PKGS)
    assert port == jax
    assert [o[0] for o in port] == ["ok", "ok", "ok", "error", "error"]
    assert [o[2] for o in port[:4]] == [1, 1, 2, 2]


class JWKSServer:
    """A JWKS document on a free local port."""

    def __init__(self, doc: dict) -> None:
        body = json.dumps(doc).encode()

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}/keys"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)


def guarded_app(pkg: str, mode: str, jwks_url: str):
    mod = importlib.import_module
    app = mod(f"{pkg}.app").App(config=mod(f"{pkg}.config").MapConfig(
        {"APP_NAME": "auth", "LOG_LEVEL": "FATAL"}))
    if mode == "basic":
        app.enable_basic_auth("admin", "secret")
    elif mode == "basic_validator":
        app.enable_basic_auth_with_validator(
            lambda u, p: u.startswith("svc-") and p == u[::-1])
    elif mode == "api_key":
        app.enable_api_key_auth("k1", "k2")
    elif mode == "api_key_validator":
        app.enable_api_key_auth_with_validator(lambda k: k.endswith("-ok"))
    elif mode == "oauth_jwks":
        app.enable_oauth(jwks_url=jwks_url)
    elif mode == "oauth_decoder":
        def decoder(token):
            if token != "let-me-in":
                raise ValueError("unknown token")
            return {"sub": "decoded", "exp": 4_000_000_000}

        app.enable_oauth(decoder)

    async def who(ctx):
        info = ctx.get_auth_info()
        return {"method": info.method, "user": info.get_username(),
                "key": info.get_api_key(), "claims": info.get_claims()}

    app.get("/who", who)
    app.post("/who", who)
    return app


def basic(user: str, password: str) -> dict:
    raw = base64.b64encode(f"{user}:{password}".encode()).decode()
    return {"Authorization": f"Basic {raw}"}


def bearer(token: str) -> dict:
    return {"Authorization": f"Bearer {token}"}


def auth_requests(keys) -> dict:
    k1, _ = keys
    live = k1.sign_jwt({"sub": "ada", "exp": time.time() + 600})
    dead = k1.sign_jwt({"sub": "ada", "exp": time.time() - 10})
    rogue = keys[1].sign_jwt({"sub": "ada"}, kid="k1")
    return {
        "basic": [("GET", "/who", {}), ("GET", "/who", basic("admin", "x")),
                  ("GET", "/who", basic("admin", "secret")),
                  ("GET", "/who", {"Authorization": "Basic %%%"}),
                  ("GET", "/who", bearer("x")),
                  ("GET", "/.well-known/alive", {}),
                  ("OPTIONS", "/who", {})],
        "basic_validator": [("GET", "/who", basic("svc-a", "a-cvs")),
                            ("GET", "/who", basic("svc-a", "nope")),
                            ("POST", "/who", basic("bob", "bob"))],
        "api_key": [("GET", "/who", {}), ("GET", "/who", {"X-Api-Key": "bad"}),
                    ("GET", "/who", {"X-Api-Key": "k2"}),
                    ("GET", "/.well-known/health", {})],
        "api_key_validator": [("GET", "/who", {"X-Api-Key": "x-ok"}),
                              ("GET", "/who", {"X-Api-Key": "x-no"})],
        "oauth_jwks": [("GET", "/who", {}), ("GET", "/who", bearer(live)),
                       ("GET", "/who", bearer(live[:-6] + "AAAAAA")),
                       ("GET", "/who", bearer(dead)),
                       ("GET", "/who", bearer(rogue)),
                       ("GET", "/who", bearer("not.a.jwt")),
                       ("GET", "/who", basic("admin", "secret")),
                       ("GET", "/.well-known/alive", {})],
        "oauth_decoder": [("GET", "/who", bearer("let-me-in")),
                          ("GET", "/who", bearer("other"))],
    }


@pytest.fixture(scope="module")
def guarded(keys):
    from aiohttp.test_utils import TestClient, TestServer

    server = JWKSServer({"keys": [keys[0].jwk("k1")]})
    reqs = auth_requests(keys)

    async def drive(pkg):
        out = {}
        for mode, calls in reqs.items():
            app = guarded_app(pkg, mode, server.url)
            client = TestClient(TestServer(app._build_http_app()))
            await client.start_server()
            try:
                res = []
                for method, path, headers in calls:
                    r = await client.request(method, path, headers=headers)
                    res.append((r.status, await r.text()))
                out[mode] = res
            finally:
                await client.close()
        return out

    try:
        return {pkg: asyncio.run(drive(pkg)) for pkg in PKGS}
    finally:
        server.close()


MODES = ["basic", "basic_validator", "api_key", "api_key_validator",
         "oauth_jwks", "oauth_decoder"]


@pytest.mark.parametrize("mode", MODES)
def test_guard_answers_match(guarded, mode):
    assert guarded["gofr_tpu_torch"][mode] == guarded["gofr_tpu"][mode]


def test_guards_admit_and_refuse_as_promised(guarded):
    got = guarded["gofr_tpu_torch"]

    def statuses(mode):
        return [s for s, _ in got[mode]]

    assert statuses("basic") == [401, 401, 200, 401, 401, 200, 200]
    assert json.loads(got["basic"][2][1])["data"] == {
        "method": "basic", "user": "admin", "key": "", "claims": {}}
    assert statuses("basic_validator") == [200, 401, 401]
    assert statuses("api_key") == [401, 401, 200, 200]
    assert json.loads(got["api_key"][2][1])["data"]["key"] == "k2"
    assert statuses("api_key_validator") == [200, 401]
    assert statuses("oauth_jwks") == [401, 200, 401, 401, 401, 401, 401, 200]
    assert json.loads(got["oauth_jwks"][1][1])["data"]["claims"]["sub"] \
        == "ada"
    assert "token expired" in got["oauth_jwks"][3][1]
    assert statuses("oauth_decoder") == [200, 401]


def test_oauth_without_a_verifier_is_refused():
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig

    app = App(config=MapConfig({"LOG_LEVEL": "FATAL"}))
    with pytest.raises(ValueError, match="jwks_url or a verifying decoder"):
        app.enable_oauth()
    app.enable_oauth(allow_unverified=True)  # tests only


def test_constant_time_equals_matches():
    from gofr_tpu.http.middleware import constant_time_equals as jax_eq
    from gofr_tpu_torch.http.middleware import constant_time_equals as eq

    for a, b in (("secret", "secret"), ("secret", "secreT"), ("", ""),
                 ("a", "ab"), ("ünï", "ünï")):
        assert eq(a, b) == jax_eq(a, b) == (a == b)
