"""RS256 bearer tokens against a JWKS document — counterpart of
``gofr_tpu/http/jwks.py``, pure Python as JAX's is.

``verify_rs256(token, n, e)`` checks an RS256 signature with the RSA
public key (n, e) by modular exponentiation: ``sig^e mod n`` must equal
the EMSA-PKCS1-v1_5 encoding of SHA-256(header.payload). It then checks
``exp`` and ``nbf`` and returns the claims; any failure raises
``JWKSError``. ``JWKSProvider`` fetches and caches a provider's JWKS
document, refreshes it every ``refresh_interval`` seconds and once on an
unknown ``kid`` (key rotation; a 10 s cooldown keeps a flood of bad
tokens from hammering the provider), and fetches in an executor so the
event loop never waits on the provider.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import time
import urllib.request
from typing import Callable

__all__ = ["JWKSProvider", "JWKSError", "verify_rs256", "decode_b64url"]

# DER prefix of the DigestInfo for SHA-256 (RFC 8017 §9.2 note 1)
_SHA256_PREFIX = bytes.fromhex("3031300d060960864801650304020105000420")


class JWKSError(Exception):
    pass


def decode_b64url(data: str | bytes) -> bytes:
    if isinstance(data, str):
        data = data.encode()
    return base64.urlsafe_b64decode(data + b"=" * (-len(data) % 4))


def _b64url_uint(data: str) -> int:
    return int.from_bytes(decode_b64url(data), "big")


def verify_rs256(token: str, n: int, e: int, *, now: float | None = None
                 ) -> dict:
    """Verify an RS256 JWT against an RSA public key (n, e); returns claims.

    Checks: signature (RSASSA-PKCS1-v1_5 / SHA-256), ``exp`` and ``nbf``.
    Raises JWKSError on any failure.
    """
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(decode_b64url(header_b64))
        claims = json.loads(decode_b64url(payload_b64))
        sig = decode_b64url(sig_b64)
    except (ValueError, json.JSONDecodeError) as exc:
        raise JWKSError(f"malformed token: {exc}") from exc
    if header.get("alg") != "RS256":
        raise JWKSError(f"unsupported alg {header.get('alg')!r}")

    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        raise JWKSError("signature length mismatch")
    em = pow(int.from_bytes(sig, "big"), e, n).to_bytes(k, "big")
    digest = hashlib.sha256(f"{header_b64}.{payload_b64}".encode()).digest()
    t = _SHA256_PREFIX + digest
    ps_len = k - len(t) - 3
    if ps_len < 8:
        raise JWKSError("key too small for RS256")
    expected = b"\x00\x01" + b"\xff" * ps_len + b"\x00" + t
    if em != expected:
        raise JWKSError("signature verification failed")

    now = time.time() if now is None else now
    if "exp" in claims and now >= float(claims["exp"]):
        raise JWKSError("token expired")
    if "nbf" in claims and now < float(claims["nbf"]):
        raise JWKSError("token not yet valid")
    return claims


class JWKSProvider:
    """Fetches and caches a JWKS document; verifies bearer tokens."""

    def __init__(self, url: str, *, refresh_interval: float = 300.0,
                 fetcher: Callable[[str], dict] | None = None,
                 logger=None) -> None:
        self.url = url
        self.refresh_interval = refresh_interval
        self._fetch = fetcher or self._default_fetcher
        self._logger = logger
        self._keys: dict[str, tuple[int, int]] = {}
        self._fetched_at = 0.0
        self._miss_cooldown_until = 0.0
        self._lock = asyncio.Lock()

    @staticmethod
    def _default_fetcher(url: str) -> dict:
        with urllib.request.urlopen(url, timeout=10) as resp:  # noqa: S310
            return json.loads(resp.read())

    def _ingest(self, doc: dict) -> None:
        keys = {}
        for jwk in doc.get("keys", []):
            if jwk.get("kty") != "RSA" or "n" not in jwk or "e" not in jwk:
                continue
            if jwk.get("use") not in (None, "sig"):
                continue
            keys[jwk.get("kid", "")] = (_b64url_uint(jwk["n"]),
                                        _b64url_uint(jwk["e"]))
        self._keys = keys
        self._fetched_at = time.monotonic()

    async def _refresh(self) -> None:
        async with self._lock:
            loop = asyncio.get_running_loop()
            try:
                doc = await loop.run_in_executor(None, self._fetch, self.url)
                self._ingest(doc)
                if self._logger is not None:
                    self._logger.debugf("jwks refreshed: %d keys from %s",
                                        len(self._keys), self.url)
            except Exception as exc:
                if self._logger is not None:
                    self._logger.errorf("jwks refresh failed: %s", exc)
                if not self._keys:
                    raise JWKSError(f"jwks fetch failed: {exc}") from exc

    async def _key_for(self, kid: str) -> tuple[int, int]:
        stale = (time.monotonic() - self._fetched_at) > self.refresh_interval
        if not self._keys or stale:
            await self._refresh()
        if kid not in self._keys:
            # rotation: one refetch, rate-limited
            if time.monotonic() >= self._miss_cooldown_until:
                self._miss_cooldown_until = time.monotonic() + 10.0
                await self._refresh()
        if kid in self._keys:
            return self._keys[kid]
        if not kid and len(self._keys) == 1:
            return next(iter(self._keys.values()))
        raise JWKSError(f"no JWKS key for kid {kid!r}")

    async def verify(self, token: str) -> dict:
        try:
            header = json.loads(decode_b64url(token.split(".")[0]))
        except (ValueError, json.JSONDecodeError) as exc:
            raise JWKSError(f"malformed token header: {exc}") from exc
        n, e = await self._key_for(header.get("kid", ""))
        return verify_rs256(token, n, e)
