"""AWS Signature Version 4 for rgw-lite.

The capability of the reference's S3 auth engine (src/rgw/rgw_auth_s3.cc
AWSv4ComplMulti / rgw_auth_s3.h: parse the Authorization header, rebuild
the canonical request from the received message, derive the signing key
from the stored secret, and compare signatures constant-time).  One
module serves both sides: `sign()` produces client headers, `verify()`
checks a received request — so the canonicalization can never drift
between signer and verifier.  verify() matches header names
case-insensitively (botocore sends 'X-Amz-Date'; rgw_auth_s3.cc
likewise lowercases before lookup).

Scope: header-based auth (Authorization: AWS4-HMAC-SHA256), single-chunk
payloads (x-amz-content-sha256 = hex digest).  Presigned URLs and
streaming chunked signatures are not implemented.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse

ALGO = "AWS4-HMAC-SHA256"
SERVICE = "s3"
MAX_SKEW_S = 15 * 60  # AWS RequestTimeTooSkewed window


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _signing_key(secret: str, date: str, region: str) -> bytes:
    k = _hmac(b"AWS4" + secret.encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, SERVICE)
    return _hmac(k, "aws4_request")


def _canonical_query(query: str) -> str:
    if not query:
        return ""
    pairs = []
    for part in query.split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        pairs.append((urllib.parse.quote(urllib.parse.unquote(k),
                                         safe="-_.~"),
                      urllib.parse.quote(urllib.parse.unquote(v),
                                         safe="-_.~")))
    return "&".join(f"{k}={v}" for k, v in sorted(pairs))


def _canonical_request(method: str, path: str, query: str,
                       headers: dict, signed_headers: list[str],
                       payload_hash: str) -> str:
    canon_uri = urllib.parse.quote(urllib.parse.unquote(path), safe="/-_.~")
    lower = {k.lower(): " ".join(str(v).split())
             for k, v in headers.items()}
    canon_headers = "".join(f"{h}:{lower.get(h, '')}\n"
                            for h in signed_headers)
    return "\n".join([method, canon_uri or "/",
                      _canonical_query(query), canon_headers,
                      ";".join(signed_headers), payload_hash])


def sign(method: str, host: str, path: str, query: str, body: bytes,
         access_key: str, secret_key: str, region: str = "us-east-1",
         now: datetime.datetime | None = None) -> dict:
    """Headers for an authenticated request (the botocore SigV4Auth
    role): Host, x-amz-date, x-amz-content-sha256, Authorization."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amzdate = now.strftime("%Y%m%dT%H%M%SZ")
    date = amzdate[:8]
    payload_hash = hashlib.sha256(body).hexdigest()
    headers = {"Host": host, "x-amz-date": amzdate,
               "x-amz-content-sha256": payload_hash}
    signed = sorted(h.lower() for h in headers)
    canon = _canonical_request(method, path, query, headers, signed,
                               payload_hash)
    scope = f"{date}/{region}/{SERVICE}/aws4_request"
    sts = "\n".join([ALGO, amzdate, scope,
                     hashlib.sha256(canon.encode()).hexdigest()])
    sig = hmac.new(_signing_key(secret_key, date, region), sts.encode(),
                   hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"{ALGO} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return headers


class AuthError(Exception):
    def __init__(self, s3code: str, http: int = 403):
        super().__init__(s3code)
        self.s3code = s3code
        self.http = http


def verify(method: str, path: str, query: str, headers: dict,
           body: bytes, lookup_secret) -> str:
    """Validate a received request; returns the access key (the
    authenticated principal).  lookup_secret(access_key) -> secret or
    None.  Raises AuthError on any failure."""
    headers = {k.lower(): v for k, v in headers.items()}
    auth = headers.get("authorization", "")
    if not auth.startswith(ALGO + " "):
        raise AuthError("AccessDenied")
    fields = {}
    for item in auth[len(ALGO) + 1:].split(","):
        k, _, v = item.strip().partition("=")
        fields[k] = v
    try:
        cred = fields["Credential"].split("/")
        access_key, date, region = cred[0], cred[1], cred[2]
        signed = fields["SignedHeaders"].split(";")
        given_sig = fields["Signature"]
    except (KeyError, IndexError):
        raise AuthError("AuthorizationHeaderMalformed") from None
    secret = lookup_secret(access_key)
    if secret is None:
        raise AuthError("InvalidAccessKeyId")
    payload_hash = headers.get("x-amz-content-sha256",
                               hashlib.sha256(body).hexdigest())
    if payload_hash != hashlib.sha256(body).hexdigest():
        raise AuthError("XAmzContentSHA256Mismatch", http=400)
    amzdate = headers.get("x-amz-date", "")
    # replay window: a captured request must not validate forever (the
    # AWS ~15-minute clock-skew rule)
    try:
        stamp = datetime.datetime.strptime(
            amzdate, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc)
    except ValueError:
        raise AuthError("AuthorizationHeaderMalformed") from None
    now = datetime.datetime.now(datetime.timezone.utc)
    if abs((now - stamp).total_seconds()) > MAX_SKEW_S:
        raise AuthError("RequestTimeTooSkewed")
    canon = _canonical_request(method, path, query, headers,
                               signed, payload_hash)
    scope = f"{date}/{region}/{SERVICE}/aws4_request"
    sts = "\n".join([ALGO, amzdate, scope,
                     hashlib.sha256(canon.encode()).hexdigest()])
    want = hmac.new(_signing_key(secret, date, region), sts.encode(),
                    hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, given_sig):
        raise AuthError("SignatureDoesNotMatch")
    return access_key
