"""rgw-lite: an S3-dialect HTTP object gateway over RADOS.

The capability slice of the reference's RGW (src/rgw/ — beast frontend
accepting S3 REST, rgw_op.cc op classes, bucket indexes maintained via
cls_rgw omap on index objects, object data striped over RADOS):

- buckets: PUT /b creates, GET /b lists (ListBucketResult XML with
  prefix= filtering), DELETE /b removes when empty, GET / lists all
  buckets; the bucket registry and each bucket's index live in omap
  (the cls_rgw index role, via the extended omap ops);
- objects: PUT /b/k stores the body striped over RADOS objects
  (Striper), GET retrieves (with Range: bytes=a-b support), HEAD
  returns metadata, DELETE removes; ETag is the body's MD5 as S3
  defines it;
- auth: AWS SigV4 header auth when the gateway is given a user
  registry (rgw_auth_s3.cc role, via services/s3auth.py); anonymous
  when not;
- multipart upload (rgw_multi.cc / RGWCompleteMultipart roles):
  initiate (POST ?uploads), UploadPart (PUT ?partNumber&uploadId),
  complete (POST ?uploadId, manifest-based — part data stays in its
  part objects, as RGW's manifest does), abort (DELETE ?uploadId),
  ListParts, ListMultipartUploads; completed-object reads (incl.
  Range) stitch across the manifest.

- multisite: every mutation appends to a per-bucket replication log
  (the cls_rgw bilog role) stamped with its ORIGIN zone; the
  /admin/bilog endpoint exposes the log tail, and services/
  multisite.py's ZoneSyncAgent tails a peer zone and applies changes —
  active-active safe (entries originated by the applying zone are
  skipped, so changes never ping-pong).

- versioning (rgw_op.cc versioned paths): per-bucket flag; versioned
  PUTs retain every generation under minted version ids, unversioned
  DELETE leaves a delete marker, versionId= addresses reads/deletes of
  specific generations, GET ?versions lists them — and the bilog
  carries version ids so multisite sync replicates exact generations;
- lifecycle (rgw_lc.h role): per-bucket rules (prefix + expiration
  days, noncurrent-version expiration); lc_process() is the LC worker
  pass the reference schedules as a daemon.
"""

from __future__ import annotations

import hashlib
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.etree import ElementTree
from xml.sax.saxutils import escape

from ..client.rados import RadosClient, RadosError
from ..client.striper import FileLayout, StripedObject
from ..msg.wire import pack_value, unpack_value
from . import s3auth

_BUCKETS_OID = "rgw_buckets"
_INDEX_OID = "rgw_index.{bucket}"
_DATA_PREFIX = "rgw_data.{bucket}.{key}"
_UPLOADS_OID = "rgw_uploads.{bucket}"
_PART_PREFIX = "rgw_mp.{bucket}.{upload}.{part:05d}"
_BILOG_OID = "rgw_bilog.{bucket}"
_VERIDX_OID = "rgw_verindex.{bucket}"
_VSEP = "\x00v"


def _localname(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _child_text(elem, *path: str) -> str | None:
    """findtext by LOCAL names — AWS SDK bodies carry the s3 xmlns,
    and namespaced children silently miss unqualified findtext."""
    cur = elem
    for name in path:
        cur = next((c for c in cur if _localname(c.tag) == name), None)
        if cur is None:
            return None
    return cur.text


def _parse_lifecycle(body: bytes) -> list[dict]:
    rules = []
    root = ElementTree.fromstring(body)
    for r in root.iter():
        if _localname(r.tag) != "Rule":
            continue
        prefix = _child_text(r, "Prefix")
        if prefix is None:
            prefix = _child_text(r, "Filter", "Prefix")
        rule = {"id": _child_text(r, "ID") or "",
                "prefix": prefix or ""}
        d = _child_text(r, "Expiration", "Days")
        if d:
            rule["days"] = float(d)
        nd = _child_text(r, "NoncurrentVersionExpiration",
                         "NoncurrentDays")
        if nd:
            rule["noncurrent_days"] = float(nd)
        rules.append(rule)
    return rules


class RgwGateway:
    """The HTTP frontend + SAL-ish store glue (rgw_process role)."""

    def __init__(self, client: RadosClient, pool: str,
                 host: str = "127.0.0.1", port: int = 0,
                 users: dict[str, str] | None = None,
                 zone: str = "default", listen: bool = True):
        """users: access_key -> secret_key registry (RGWUserInfo role);
        None = anonymous gateway (no auth enforced).  zone names this
        gateway's multisite zone (bilog origin stamping).  listen=False
        skips binding the HTTP frontend entirely — a store-only
        gateway for callers (the saturation harness) that drive
        put_object/get_object directly."""
        self.client = client
        self.pool = pool
        self.users = dict(users) if users is not None else None
        self.zone = zone
        self._bilog_lock = threading.Lock()
        self._bilog_seq: dict[str, int] = {}
        self._push_endpoints: dict = {}   # topic -> callable (push)
        self._notify_lock = threading.Lock()
        self._nseq = 0                    # notification seq tiebreak
        self.host = host
        # swift TempAuth sessions: token -> (user, expiry)
        self._swift_tokens: dict[str, tuple[str, float]] = {}
        gw = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes = b"",
                      ctype: str = "application/xml",
                      headers: dict | None = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def _error(self, code: int, s3code: str):
                body = (f'<?xml version="1.0"?><Error><Code>{s3code}'
                        f'</Code></Error>').encode()
                self._send(code, body)

            def _route(self):
                path = self.path.split("?", 1)[0].strip("/")
                query = self.path.split("?", 1)[1] \
                    if "?" in self.path else ""
                parts = path.split("/", 1)
                # S3 clients percent-encode keys; store the DECODED form
                bucket = urllib.parse.unquote(parts[0]) \
                    if parts[0] else None
                key = urllib.parse.unquote(parts[1]) \
                    if len(parts) > 1 else None
                return bucket, key, query

            def _qs(self, query: str) -> dict:
                return {k: v[0] for k, v in
                        urllib.parse.parse_qs(
                            query, keep_blank_values=True).items()}

            def _auth(self, body: bytes = b""):
                """SigV4 gate on every verb when a user registry is
                configured; replies the S3 error shape on failure.
                Returns the authenticated principal ("" when the
                gateway is anonymous), or None after replying 4xx."""
                if gw.users is None:
                    return ""
                path = self.path.split("?", 1)[0]
                query = self.path.split("?", 1)[1] \
                    if "?" in self.path else ""
                try:
                    who = s3auth.verify(
                        self.command, path, query,
                        {k: v for k, v in self.headers.items()},
                        body, gw.auth_lookup)
                except s3auth.AuthError as e:
                    self._error(e.http, e.s3code)
                    return None
                if who.startswith("STS") and who not in gw.users:
                    # temporary credentials (a REGISTERED key that
                    # happens to start with STS stays a normal user):
                    # the live session token must ride the request and
                    # the principal becomes the ROLE
                    # (rgw_rest_sts.cc session semantics).  One record
                    # fetch serves both the token gate and the
                    # underlying-user attribution.
                    rec = gw._sts_record(who)
                    token = self.headers.get("x-amz-security-token")
                    if rec is None or token != rec["token"]:
                        self._error(403, "AccessDenied")
                        return None
                    self._sts_user = rec["principal"]
                    who = f"sts:{rec['role']}"
                return who

            def _allow(self, who, bucket, action) -> bool:
                try:
                    gw.authorize(who, bucket, action)
                    return True
                except PermissionError:
                    self._error(403, "AccessDenied")
                    return False

            def _owner_gate(self, who, bucket) -> bool:
                """Bucket-config surface (policy/versioning/
                lifecycle/delete/re-create): strictly owner-scoped.
                Replies 403 itself on refusal."""
                try:
                    owner = gw.bucket_owner(bucket)
                except KeyError:
                    owner = ""
                if gw.users is not None and owner and who != owner:
                    self._error(403, "AccessDenied")
                    return False
                return True

            # ----------------------------------------------- swift API
            # (the rgw Swift dialect, src/rgw/rgw_rest_swift.cc over
            # the SAME buckets/objects the S3 surface serves — rgw's
            # dual-protocol contract): TempAuth-style token mint at
            # /auth/v1.0, then /swift/v1/<container>[/<object>] with
            # X-Auth-Token.  Listings are text/plain like Swift's.
            def _swift(self, body: bytes = b"") -> bool:
                """Handle the request if it is a Swift-dialect path;
                returns True when fully handled."""
                path = self.path.split("?", 1)[0]
                if path == "/auth/v1.0":
                    user = self.headers.get("X-Auth-User", "")
                    key = self.headers.get("X-Auth-Key", "")
                    token = gw.swift_auth(user, key)
                    if token is None:
                        self._send(401, b"", ctype="text/plain")
                        return True
                    self._send(204, b"", ctype="text/plain", headers={
                        "X-Auth-Token": token,
                        "X-Storage-Url":
                            f"http://{gw.host}:{gw.port}/swift/v1"})
                    return True
                if path != "/swift/v1" and \
                        not path.startswith("/swift/v1/"):
                    return False  # e.g. S3 bucket "swift", key "v1x"
                who = gw.swift_principal(
                    self.headers.get("X-Auth-Token", ""))
                if who is None:
                    self._send(401, b"", ctype="text/plain")
                    return True
                rest = path[len("/swift/v1"):].strip("/")
                container, _, obj = rest.partition("/")
                container = urllib.parse.unquote(container) or None
                obj = urllib.parse.unquote(obj) or None
                try:
                    self._swift_op(who, container, obj, body)
                except KeyError:
                    self._send(404, b"", ctype="text/plain")
                except PermissionError:
                    self._send(403, b"", ctype="text/plain")
                except ValueError:
                    self._send(409, b"", ctype="text/plain")
                except Exception:  # noqa: BLE001 - degraded cluster
                    self._send(503, b"", ctype="text/plain")
                return True

            def _swift_op(self, who, container, obj, body) -> None:
                v = self.command
                if container is None:
                    if v == "GET":  # account listing: containers
                        names = sorted(gw._buckets())
                        self._send(200, ("\n".join(names) + "\n").encode()
                                   if names else b"",
                                   ctype="text/plain")
                    else:
                        self._send(405, b"", ctype="text/plain")
                    return
                if obj is None:
                    if v == "PUT":
                        try:
                            gw.check_bucket(container)
                            # re-PUT mirrors the S3 contract: never a
                            # silent success for a non-owner
                            owner = gw.bucket_owner(container)
                            if gw.users is not None and owner \
                                    and who != owner:
                                raise PermissionError(container)
                        except KeyError:
                            gw.create_bucket(container)
                            if who:
                                gw.set_bucket_owner(container, who)
                        self._send(201, b"", ctype="text/plain")
                    elif v == "GET":
                        gw.authorize(who, container, "s3:ListBucket")
                        gw.check_bucket(container)
                        # delete-marker heads are not live objects —
                        # same filter as the S3 listing
                        names = sorted(
                            k for k, m in gw._index(container).items()
                            if not m.get("delete_marker"))
                        self._send(200, ("\n".join(names) + "\n").encode()
                                   if names else b"",
                                   ctype="text/plain")
                    elif v == "DELETE":
                        gw.check_bucket(container)
                        # bucket deletion is OWNER-scoped on the S3
                        # surface; the Swift surface must not widen it
                        # through a policy Allow
                        owner = gw.bucket_owner(container)
                        if gw.users is not None and owner \
                                and who != owner:
                            raise PermissionError(container)
                        if gw._index(container):
                            self._send(409, b"", ctype="text/plain")
                            return
                        gw.delete_bucket(container)
                        self._send(204, b"", ctype="text/plain")
                    else:
                        self._send(405, b"", ctype="text/plain")
                    return
                if v == "PUT":
                    gw.authorize(who, container, "s3:PutObject")
                    gw.check_bucket(container)
                    etag = gw.put_object(container, obj, body)
                    self._send(201, b"", ctype="text/plain",
                               headers={"ETag": etag})
                elif v in ("GET", "HEAD"):
                    gw.authorize(who, container, "s3:GetObject")
                    meta = gw.head_object(container, obj)
                    data = b""
                    if v == "GET":
                        data = gw._read_extent(container, obj, meta, 0,
                                               meta["size"])
                    hdrs = {"ETag": meta.get("etag", "")}
                    if v == "HEAD":
                        hdrs["X-Object-Size"] = str(meta.get("size", 0))
                    self._send(200, data, ctype="application/"
                               "octet-stream", headers=hdrs)
                elif v == "DELETE":
                    gw.authorize(who, container, "s3:DeleteObject")
                    gw.delete_object(container, obj)
                    self._send(204, b"", ctype="text/plain")
                else:
                    self._send(405, b"", ctype="text/plain")

            # ----------------------------------------------------- verbs
            def do_GET(self):  # noqa: N802
                if self._swift():
                    return
                who = self._auth()
                if who is None:
                    return
                bucket, key, query = self._route()
                qs = self._qs(query)
                if bucket is not None and bucket != "admin":
                    if key is None and any(
                            q in qs for q in ("policy", "versioning",
                                              "lifecycle")):
                        # config reads expose grants/denies and rule
                        # sets: owner-only, like the config writes
                        if not self._owner_gate(who, bucket):
                            return
                    else:
                        action = "s3:GetObject" if key is not None \
                            else "s3:ListBucket"
                        if not self._allow(who, bucket, action):
                            return
                try:
                    if bucket == "admin" and key == "bilog":
                        # multisite: the bucket-index log tail (the
                        # radosgw-admin bilog list / datalog role).
                        # The log leaks the TARGET bucket's key listing
                        # — same authorization as listing it
                        target = qs.get("bucket", "")
                        if not self._allow(who, target,
                                           "s3:ListBucket"):
                            return
                        import json as _json
                        entries = gw.bilog_since(
                            target, int(qs.get("marker", 0)))
                        self._send(200, _json.dumps(entries).encode(),
                                   ctype="application/json")
                    elif bucket is None:
                        self._send(200, gw.list_buckets_xml())
                    elif key is None and "uploads" in qs:
                        self._send(200, gw.list_uploads_xml(bucket))
                    elif key is None and "versions" in qs:
                        prefix = urllib.parse.unquote(
                            qs.get("prefix", ""))
                        self._send(200, gw.list_versions_xml(bucket,
                                                             prefix))
                    elif key is None and "versioning" in qs:
                        status = ("Enabled"
                                  if gw.versioning_enabled(bucket)
                                  else "Suspended")
                        self._send(200, (
                            '<?xml version="1.0"?>'
                            "<VersioningConfiguration><Status>"
                            f"{status}</Status>"
                            "</VersioningConfiguration>").encode())
                    elif key is None and "policy" in qs:
                        import json as _json
                        pol = gw.get_bucket_policy(bucket)
                        if pol is None:
                            self._error(404, "NoSuchBucketPolicy")
                        else:
                            self._send(200, _json.dumps(pol).encode(),
                                       ctype="application/json")
                    elif key is None and "lifecycle" in qs:
                        rules = gw.get_lifecycle(bucket)
                        items = "".join(
                            f"<Rule><ID>{escape(str(r.get('id', '')))}"
                            f"</ID><Prefix>{escape(r.get('prefix', ''))}"
                            f"</Prefix></Rule>" for r in rules)
                        self._send(200, (
                            '<?xml version="1.0"?>'
                            f"<LifecycleConfiguration>{items}"
                            "</LifecycleConfiguration>").encode())
                    elif key is None:
                        prefix = urllib.parse.unquote(
                            qs.get("prefix", ""))
                        self._send(200, gw.list_objects_xml(bucket,
                                                            prefix))
                    elif "uploadId" in qs:
                        self._send(200, gw.list_parts_xml(
                            bucket, key, qs["uploadId"]))
                    else:
                        rng = self.headers.get("Range")
                        data, meta, status = gw.get_object(
                            bucket, key, rng,
                            version_id=qs.get("versionId"))
                        hdrs = {"ETag": f'"{meta["etag"]}"'}
                        if meta.get("version_id"):
                            hdrs["x-amz-version-id"] = \
                                meta["version_id"]
                        self._send(status, data,
                                   ctype="application/octet-stream",
                                   headers=hdrs)
                except KeyError:
                    self._error(404, "NoSuchKey")

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                who = self._auth(body)
                if who is None:
                    return
                bucket, key, query = self._route()
                qs = self._qs(query)
                if bucket is not None and \
                        not self._allow(who, bucket, "s3:PutObject"):
                    return
                try:
                    if key is not None and "uploads" in qs:
                        upload_id = gw.initiate_multipart(bucket, key)
                        xml = (f'<?xml version="1.0"?>'
                               f"<InitiateMultipartUploadResult>"
                               f"<Bucket>{escape(bucket)}</Bucket>"
                               f"<Key>{escape(key)}</Key>"
                               f"<UploadId>{upload_id}</UploadId>"
                               f"</InitiateMultipartUploadResult>")
                        self._send(200, xml.encode())
                    elif key is not None and "uploadId" in qs:
                        parts = []
                        root = ElementTree.fromstring(body)
                        for p in root.iter():
                            if p.tag.endswith("Part"):
                                n = int(p.findtext("PartNumber"))
                                etag = (p.findtext("ETag") or "").strip('"')
                                parts.append((n, etag))
                        etag = gw.complete_multipart(
                            bucket, key, qs["uploadId"], parts)
                        xml = (f'<?xml version="1.0"?>'
                               f"<CompleteMultipartUploadResult>"
                               f"<Key>{escape(key)}</Key>"
                               f'<ETag>"{etag}"</ETag>'
                               f"</CompleteMultipartUploadResult>")
                        self._send(200, xml.encode())
                    else:
                        self._error(400, "InvalidRequest")
                except KeyError:
                    self._error(404, "NoSuchUpload")
                except ValueError:
                    self._error(400, "InvalidPart")

            def do_HEAD(self):  # noqa: N802
                if self._swift():
                    return
                who = self._auth()
                if who is None:
                    return
                bucket, key, _ = self._route()
                if bucket is not None and \
                        not self._allow(who, bucket, "s3:GetObject"):
                    return
                try:
                    if key is None:
                        gw.check_bucket(bucket)
                        self._send(200)
                    else:
                        meta = gw.head_object(bucket, key)
                        self._send(200, headers={
                            "ETag": f'"{meta["etag"]}"',
                            "X-Object-Size": str(meta["size"])})
                except KeyError:
                    self._error(404, "NoSuchKey")

            def do_PUT(self):  # noqa: N802
                bucket, key, query = self._route()
                qs = self._qs(query)
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                if self._swift(body):
                    return
                who = self._auth(body)
                if who is None:
                    return
                # bucket-config verbs (versioning/lifecycle/policy) and
                # bucket creation are owner-scoped; object writes go
                # through the policy
                if key is not None and \
                        not self._allow(who, bucket, "s3:PutObject"):
                    return
                if key is None and any(q in qs for q in
                                       ("versioning", "lifecycle",
                                        "policy")):
                    if not self._owner_gate(who, bucket):
                        return
                try:
                    if key is None and "policy" in qs:
                        import json as _json
                        gw.check_bucket(bucket)
                        gw.set_bucket_policy(bucket,
                                             _json.loads(body))
                        self._send(200)
                        return
                    if key is None and "versioning" in qs:
                        gw.check_bucket(bucket)
                        root = ElementTree.fromstring(body)
                        status = (_child_text(root, "Status")
                                  or "").strip()
                        gw.set_versioning(bucket,
                                          status == "Enabled")
                        self._send(200)
                    elif key is None and "lifecycle" in qs:
                        gw.check_bucket(bucket)
                        gw.set_lifecycle(bucket,
                                         _parse_lifecycle(body))
                        self._send(200)
                    elif key is None:
                        try:
                            gw.check_bucket(bucket)
                            exists = True
                        except KeyError:
                            exists = False
                        if exists:
                            # re-PUT must neither clobber the record
                            # (owner/policy/versioning) nor transfer
                            # ownership — S3: your own bucket is a
                            # no-op 200, someone else's refuses
                            if not self._owner_gate(who, bucket):
                                return
                            self._send(200)
                        else:
                            if who.startswith("sts:"):
                                # temporary credentials may only
                                # create buckets their ROLE policy
                                # allows, and ownership goes to the
                                # assuming USER — a role principal as
                                # owner would hand every session of
                                # that role owner powers
                                if not gw._role_policy_allows(
                                        who.split(":", 1)[1], bucket,
                                        "s3:CreateBucket"):
                                    self._error(403, "AccessDenied")
                                    return
                            gw.create_bucket(bucket)
                            owner = who
                            if who.startswith("sts:"):
                                owner = getattr(self, "_sts_user", "")
                            if owner:
                                gw.set_bucket_owner(bucket, owner)
                            self._send(200)
                    elif "partNumber" in qs and "uploadId" in qs:
                        etag = gw.put_part(bucket, key, qs["uploadId"],
                                           int(qs["partNumber"]), body)
                        self._send(200, headers={"ETag": f'"{etag}"'})
                    else:
                        etag = gw.put_object(bucket, key, body)
                        self._send(200, headers={"ETag": f'"{etag}"'})
                except KeyError:
                    self._error(404, "NoSuchBucket")

            def do_DELETE(self):  # noqa: N802
                if self._swift():
                    return
                who = self._auth()
                if who is None:
                    return
                bucket, key, query = self._route()
                qs = self._qs(query)
                if key is not None and \
                        not self._allow(who, bucket,
                                        "s3:DeleteObject"):
                    return
                if key is None and not self._owner_gate(who, bucket):
                    return
                try:
                    if key is None and "policy" in qs:
                        gw.delete_bucket_policy(bucket)
                        self._send(204)
                        return
                    if key is not None and "uploadId" in qs:
                        gw.abort_multipart(bucket, key, qs["uploadId"])
                        self._send(204)
                    elif key is None:
                        gw.delete_bucket(bucket)
                        self._send(204)
                    else:
                        res = gw.delete_object(
                            bucket, key,
                            version_id=qs.get("versionId"))
                        hdrs = {}
                        if res.get("delete_marker"):
                            hdrs["x-amz-delete-marker"] = "true"
                        if res.get("version_id"):
                            hdrs["x-amz-version-id"] = \
                                res["version_id"]
                        self._send(204, headers=hdrs)
                except KeyError:
                    self._error(404, "NoSuchKey")
                except ValueError:
                    self._error(409, "BucketNotEmpty")

        if listen:
            self._server = ThreadingHTTPServer((host, port), Handler)
            self.port = self._server.server_address[1]
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name="rgw-frontend", daemon=True)
            self._thread.start()
        else:
            self._server = None
            self.port = 0

    # ---------------------------------------------------- swift auth
    SWIFT_TOKEN_TTL = 3600.0

    def swift_auth(self, user: str, key: str) -> str | None:
        """TempAuth mint (GET /auth/v1.0): the SAME user registry the
        S3 surface authenticates — rgw's one-user-two-protocols shape.
        None = bad credentials."""
        if self.users is None:
            user = ""          # anonymous gateway: unauthenticated ok
        elif self.users.get(user) != key:
            return None
        import secrets as _secrets
        now = time.time()
        # sweep on mint: expired sessions must not accumulate for the
        # gateway's lifetime
        for t, (_u, exp) in list(self._swift_tokens.items()):
            if now > exp:
                self._swift_tokens.pop(t, None)
        token = "AUTH_tk" + _secrets.token_hex(16)
        self._swift_tokens[token] = (user, now + self.SWIFT_TOKEN_TTL)
        return token

    def swift_principal(self, token: str) -> str | None:
        """Live session lookup; expired/unknown tokens reject (401).
        Anonymous gateways accept tokenless requests."""
        if self.users is None:
            return ""
        ent = self._swift_tokens.get(token)
        if ent is None:
            return None
        user, expiry = ent
        if time.time() > expiry:
            self._swift_tokens.pop(token, None)
            return None
        return user

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()

    # ------------------------------------------------------------ buckets
    def _buckets(self) -> dict:
        try:
            return self.client.omap_get(self.pool, _BUCKETS_OID)
        except RadosError:
            return {}

    def _bucket_rec(self, bucket: str) -> dict:
        raw = self._buckets().get(bucket)
        if raw is None:
            raise KeyError(bucket)
        rec = unpack_value(raw)
        if not isinstance(rec, dict):  # pre-versioning stamp: a float
            rec = {"created": float(rec)}
        return rec

    def _bucket_rec_set(self, bucket: str, rec: dict) -> None:
        self.client.omap_set(self.pool, _BUCKETS_OID,
                             {bucket: pack_value(rec)})

    def create_bucket(self, bucket: str) -> None:
        self.client.omap_set(
            self.pool, _BUCKETS_OID,
            {bucket: pack_value({"created": time.time()})})

    def check_bucket(self, bucket: str) -> None:
        if bucket not in self._buckets():
            raise KeyError(bucket)

    # ----------------------------------------------------------- STS
    # (the rgw STS slice, src/rgw/rgw_sts.h + rgw_rest_sts.cc
    # AssumeRole: IAM roles with a TRUST list and a permission policy;
    # assumption mints time-limited credentials — access key, secret,
    # session token — that authenticate through the normal SigV4 path
    # with the token required, and authorize against the ROLE's policy
    # instead of ownership.)
    _ROLES_OID = "rgw_roles"
    _STS_OID = "rgw_sts_tokens"

    def create_role(self, name: str, trust: list[str],
                    policy: dict) -> None:
        """IAM CreateRole: `trust` lists the principals permitted to
        assume the role; `policy` is the AWS-shaped permission policy
        evaluated for the temporary principal."""
        if not isinstance(policy.get("Statement"), list):
            raise ValueError("role policy needs a Statement list")
        self.client.omap_set(
            self.pool, self._ROLES_OID,
            {name: pack_value({"trust": list(trust),
                               "policy": policy,
                               "created": time.time()})})

    def list_roles(self) -> list[str]:
        try:
            return sorted(self.client.omap_get(self.pool,
                                               self._ROLES_OID))
        except RadosError:
            return []

    def assume_role(self, principal: str, role: str,
                    duration: float = 3600.0) -> dict:
        """STS AssumeRole: trust-gated minting of temporary
        credentials.  The caller authenticates as itself first (the
        gateway calls this after SigV4, or a test calls it directly
        with a verified principal)."""
        try:
            raw = self.client.omap_get(self.pool,
                                       self._ROLES_OID).get(role)
        except RadosError:
            raw = None
        if raw is None:
            raise KeyError(f"no role {role!r}")
        rec = unpack_value(raw)
        if principal not in rec.get("trust", []):
            raise PermissionError(
                f"{principal} is not trusted by role {role}")
        import secrets as _secrets
        access = "STS" + _secrets.token_hex(8).upper()
        secret = _secrets.token_hex(20)
        token = _secrets.token_hex(16)
        expiry = time.time() + float(duration)
        self.client.omap_set(
            self.pool, self._STS_OID,
            {access: pack_value({"secret": secret, "token": token,
                                 "role": role, "principal": principal,
                                 "expiry": expiry})})
        return {"access_key": access, "secret_key": secret,
                "session_token": token, "expiration": expiry,
                "role": role}

    def _sts_record(self, access_key: str) -> dict | None:
        """Live temporary-credential record, purging on expiry (the
        session-expiry renewal forcing function)."""
        if not access_key.startswith("STS"):
            return None
        try:
            raw = self.client.omap_get(self.pool,
                                       self._STS_OID).get(access_key)
        except RadosError:
            return None
        if raw is None:
            return None
        rec = unpack_value(raw)
        if time.time() > float(rec.get("expiry", 0)):
            try:
                self.client.omap_rm(self.pool, self._STS_OID,
                                    [access_key])
            except RadosError:
                pass
            return None
        return rec

    def auth_lookup(self, access_key: str):
        """SigV4 secret resolution across BOTH credential classes:
        long-lived users and live STS sessions."""
        if self.users and access_key in self.users:
            return self.users[access_key]
        rec = self._sts_record(access_key)
        return rec["secret"] if rec is not None else None

    def sts_principal(self, access_key: str,
                      session_token: str | None) -> str | None:
        """After SigV4 passes for an STS access key: require the live
        session token and map the caller to its role principal
        ("sts:<role>").  None = reject."""
        rec = self._sts_record(access_key)
        if rec is None or session_token != rec["token"]:
            return None
        return f"sts:{rec['role']}"

    def _role_policy_allows(self, role: str, bucket: str,
                            action: str) -> bool:
        try:
            raw = self.client.omap_get(self.pool,
                                       self._ROLES_OID).get(role)
        except RadosError:
            raw = None
        if raw is None:
            return False
        allowed = False
        for stmt in unpack_value(raw).get("policy", {}) \
                .get("Statement", []):
            if not (self._action_matches(stmt.get("Action", []), action)
                    and self._resource_matches(
                        stmt.get("Resource", ["*"]), bucket)):
                continue
            if stmt.get("Effect") == "Deny":
                return False
            if stmt.get("Effect") == "Allow":
                allowed = True
        return allowed

    # ------------------------------------------------- notifications
    # (the rgw pubsub/bucket-notification slice, src/rgw/rgw_notify.h
    # + rgw_pubsub.h: SNS-shaped TOPICS, per-bucket notification
    # configurations with event-type and prefix/suffix filters, and
    # S3-shaped event records delivered to a durable per-topic queue
    # (pull mode) and/or a push endpoint.  Push here is an in-process
    # callable — the HTTP/AMQP/Kafka transports of the reference are
    # deployment plumbing around the same record.)
    _TOPICS_OID = "rgw_topics"
    _QUEUE_OID = "rgw_queue.{topic}"

    def create_topic(self, name: str, push_endpoint=None) -> None:
        """SNS CreateTopic role.  push_endpoint: optional callable
        invoked per event (best-effort; the durable queue keeps the
        record either way — the persistent-queue delivery contract)."""
        self.client.omap_set(
            self.pool, self._TOPICS_OID,
            {name: pack_value({"created": time.time()})})
        if push_endpoint is not None:
            self._push_endpoints[name] = push_endpoint

    def delete_topic(self, name: str) -> None:
        """Removes the topic, its durable queue (undelivered records
        must not leak to a future topic of the same name), and every
        bucket configuration referencing it (events would otherwise
        keep accumulating in an orphaned queue forever)."""
        self.client.omap_rm(self.pool, self._TOPICS_OID, [name])
        self._push_endpoints.pop(name, None)
        try:
            q = self._QUEUE_OID.format(topic=name)
            keys = list(self.client.omap_get(self.pool, q))
            if keys:
                self.client.omap_rm(self.pool, q, keys)
        except RadosError:
            pass
        for bucket in list(self._buckets()):
            try:
                rec = self._bucket_rec(bucket)
            except KeyError:
                continue
            cfgs = rec.get("notifications", [])
            kept = [c for c in cfgs if c.get("topic") != name]
            if len(kept) != len(cfgs):
                rec["notifications"] = kept
                self._bucket_rec_set(bucket, rec)

    def list_topics(self) -> list[str]:
        return sorted(self._topics())

    def _topics(self) -> dict:
        try:
            return {k: unpack_value(v) for k, v in self.client.omap_get(
                self.pool, self._TOPICS_OID).items()}
        except RadosError:
            return {}

    def put_bucket_notification(self, bucket: str,
                                configs: list[dict]) -> None:
        """PutBucketNotificationConfiguration role: each config is
        {"id", "topic", "events": ["s3:ObjectCreated:*", ...],
        "prefix": "", "suffix": ""}."""
        topics = self._topics()
        for cfg in configs:
            if cfg.get("topic") not in topics:
                raise KeyError(f"no topic {cfg.get('topic')!r}")
            for ev in cfg.get("events", []):
                if not ev.startswith("s3:"):
                    raise ValueError(f"bad event type {ev!r}")
        rec = self._bucket_rec(bucket)
        rec["notifications"] = list(configs)
        self._bucket_rec_set(bucket, rec)

    def get_bucket_notification(self, bucket: str) -> list[dict]:
        return list(self._bucket_rec(bucket).get("notifications", []))

    @staticmethod
    def _event_matches(cfg: dict, event: str, key: str) -> bool:
        ok = False
        for want in cfg.get("events", []):
            if want == event or (want.endswith(":*")
                                 and event.startswith(want[:-1])):
                ok = True
                break
        if not ok:
            return False
        if cfg.get("prefix") and not key.startswith(cfg["prefix"]):
            return False
        if cfg.get("suffix") and not key.endswith(cfg["suffix"]):
            return False
        return True

    def _notify(self, bucket: str, event: str, key: str,
                etag: str = "", size: int = 0,
                version_id: str = "") -> None:
        try:
            configs = self._bucket_rec(bucket).get("notifications", [])
        except KeyError:
            return
        if not configs:
            return
        record = None
        for cfg in configs:
            if not self._event_matches(cfg, event, key):
                continue
            if record is None:
                # the S3 event record shape (Records[0] essentials)
                record = {"eventVersion": "2.2", "eventSource":
                          "ceph:tpu:s3", "awsRegion": self.zone,
                          "eventTime": time.time(), "eventName": event,
                          "s3": {"configurationId": "",
                                 "bucket": {"name": bucket},
                                 "object": {"key": key, "eTag": etag,
                                            "size": size,
                                            "versionId": version_id}}}
            rec = dict(record)
            rec["s3"] = dict(record["s3"],
                             configurationId=cfg.get("id", ""))
            topic = cfg["topic"]
            # durable queue first (persistent delivery), then the
            # best-effort push endpoint
            oid = self._QUEUE_OID.format(topic=topic)
            with self._notify_lock:
                # key minting must be atomic: two handler threads
                # minting the same (time, seq) key would overwrite one
                # record and break the durable-delivery contract
                self._nseq += 1
                qkey = f"{time.time():017.6f}.{self._nseq:08d}"
            self.client.omap_set(self.pool, oid,
                                 {qkey: pack_value(rec)})
            ep = self._push_endpoints.get(topic)
            if ep is not None:
                try:
                    ep(rec)
                except Exception:  # noqa: BLE001 - push is best-effort
                    pass

    def pull_events(self, topic: str, max_events: int = 100,
                    ack: bool = True) -> list[dict]:
        """Pull-mode consumption of a topic's durable queue; ack
        removes the delivered records (the pubsub ack contract)."""
        oid = self._QUEUE_OID.format(topic=topic)
        try:
            raw = self.client.omap_get(self.pool, oid)
        except RadosError:
            return []
        keys = sorted(raw)[:max_events]
        out = [unpack_value(raw[k]) for k in keys]
        if ack and keys:
            self.client.omap_rm(self.pool, oid, keys)
        return out

    # ----------------------------------------------------------- IAM
    # (the rgw IAM/bucket-policy slice, src/rgw/rgw_iam_policy.{h,cc}:
    # buckets have OWNERS; non-owners are admitted only by an attached
    # AWS-shaped bucket policy; explicit Deny outranks Allow; anything
    # unmatched is denied.  Anonymous gateways — no user registry —
    # skip enforcement entirely, as before.)
    def set_bucket_owner(self, bucket: str, owner: str) -> None:
        rec = self._bucket_rec(bucket)
        rec["owner"] = owner
        self._bucket_rec_set(bucket, rec)

    def bucket_owner(self, bucket: str) -> str:
        return str(self._bucket_rec(bucket).get("owner", ""))

    def set_bucket_policy(self, bucket: str, policy: dict) -> None:
        stmts = policy.get("Statement")
        if not isinstance(stmts, list):
            raise ValueError("policy needs a Statement list")
        rec = self._bucket_rec(bucket)
        rec["policy"] = policy
        self._bucket_rec_set(bucket, rec)

    def get_bucket_policy(self, bucket: str) -> dict | None:
        return self._bucket_rec(bucket).get("policy")

    def delete_bucket_policy(self, bucket: str) -> None:
        rec = self._bucket_rec(bucket)
        rec.pop("policy", None)
        self._bucket_rec_set(bucket, rec)

    @staticmethod
    def _action_matches(actions, action: str) -> bool:
        """ONE action matcher for bucket and role policies — split
        evaluators silently diverge on wildcard support."""
        if isinstance(actions, str):
            actions = [actions]
        return any(a in ("*", "s3:*", action) for a in actions)

    @staticmethod
    def _resource_matches(resources, bucket: str) -> bool:
        if isinstance(resources, str):
            resources = [resources]
        return any(r in ("*", bucket)
                   or (r.endswith("*") and r.rstrip("*")
                       and bucket.startswith(r.rstrip("*")))
                   for r in resources)

    @staticmethod
    def _stmt_matches(stmt: dict, principal: str, action: str) -> bool:
        pr = stmt.get("Principal", {})
        if pr != "*":
            aws = pr.get("AWS", []) if isinstance(pr, dict) else []
            if isinstance(aws, str):
                aws = [aws]
            if "*" not in aws and principal not in aws:
                return False
        return RgwGateway._action_matches(stmt.get("Action", []),
                                          action)

    def authorize(self, principal: str, bucket: str,
                  action: str) -> None:
        """Raise PermissionError unless `principal` may perform
        `action` on `bucket` (owner always may; then the bucket
        policy decides: explicit Deny wins, unmatched denies)."""
        if self.users is None:
            return  # anonymous gateway: no enforcement
        try:
            rec = self._bucket_rec(bucket)
        except KeyError:
            return  # bucket existence errors surface as 404 later
        if principal.startswith("sts:"):
            # temporary credentials: the ROLE's permission policy is
            # the authority (never ownership); an explicit resource-
            # policy Deny naming the role principal still wins
            for stmt in (rec.get("policy") or {}).get("Statement", []):
                if self._stmt_matches(stmt, principal, action) \
                        and stmt.get("Effect") == "Deny":
                    raise PermissionError(action)
            if not self._role_policy_allows(principal[4:], bucket,
                                            action):
                raise PermissionError(action)
            return
        owner = rec.get("owner", "")
        if not owner or principal == owner:
            return  # unowned (legacy) buckets stay open to auth'd users
        policy = rec.get("policy") or {}
        allowed = False
        for stmt in policy.get("Statement", []):
            if not self._stmt_matches(stmt, principal, action):
                continue
            if stmt.get("Effect") == "Deny":
                raise PermissionError(action)
            if stmt.get("Effect") == "Allow":
                allowed = True
        if not allowed:
            raise PermissionError(action)

    # ---------------------------------------------------- versioning flag
    def set_versioning(self, bucket: str, enabled: bool) -> None:
        rec = self._bucket_rec(bucket)
        rec["versioning"] = bool(enabled)
        self._bucket_rec_set(bucket, rec)

    def versioning_enabled(self, bucket: str) -> bool:
        try:
            return bool(self._bucket_rec(bucket).get("versioning"))
        except KeyError:
            return False

    def delete_bucket(self, bucket: str) -> None:
        self.check_bucket(bucket)
        if self._index(bucket):
            raise ValueError("not empty")
        self.client.omap_rm(self.pool, _BUCKETS_OID, [bucket])

    def list_buckets_xml(self) -> bytes:
        names = sorted(self._buckets())
        items = "".join(f"<Bucket><Name>{escape(n)}</Name></Bucket>"
                        for n in names)
        return (f'<?xml version="1.0"?><ListAllMyBucketsResult>'
                f"<Buckets>{items}</Buckets>"
                f"</ListAllMyBucketsResult>").encode()

    # ------------------------------------------------------- bucket index
    def _index(self, bucket: str) -> dict:
        try:
            raw = self.client.omap_get(self.pool,
                                       _INDEX_OID.format(bucket=bucket))
        except RadosError:
            return {}
        return {k: unpack_value(v) for k, v in raw.items()}

    def _index_set(self, bucket: str, key: str, meta: dict) -> None:
        self.client.omap_set(self.pool, _INDEX_OID.format(bucket=bucket),
                             {key: pack_value(meta)})

    def _index_rm(self, bucket: str, key: str) -> None:
        self.client.omap_rm(self.pool, _INDEX_OID.format(bucket=bucket),
                            [key])

    def list_objects_xml(self, bucket: str, prefix: str = "") -> bytes:
        self.check_bucket(bucket)
        idx = self._index(bucket)
        items = []
        for key in sorted(idx):
            if prefix and not key.startswith(prefix):
                continue
            meta = idx[key]
            if meta.get("delete_marker"):
                continue  # a marker head hides the key (S3 list)
            items.append(
                f"<Contents><Key>{escape(key)}</Key>"
                f"<Size>{meta['size']}</Size>"
                f"<ETag>&quot;{meta['etag']}&quot;</ETag></Contents>")
        return (f'<?xml version="1.0"?><ListBucketResult>'
                f"<Name>{escape(bucket)}</Name>"
                f"<Prefix>{escape(prefix)}</Prefix>"
                f"{''.join(items)}</ListBucketResult>").encode()

    # -------------------------------------------------- version index
    def _verindex(self, bucket: str) -> dict:
        try:
            raw = self.client.omap_get(
                self.pool, _VERIDX_OID.format(bucket=bucket))
        except RadosError:
            return {}
        return {k: unpack_value(v) for k, v in raw.items()}

    def _verindex_set(self, bucket: str, key: str, vid: str,
                      meta: dict) -> None:
        self.client.omap_set(self.pool,
                             _VERIDX_OID.format(bucket=bucket),
                             {f"{key}{_VSEP}{vid}": pack_value(meta)})

    def _verindex_rm(self, bucket: str, key: str, vid: str) -> None:
        try:
            self.client.omap_rm(self.pool,
                                _VERIDX_OID.format(bucket=bucket),
                                [f"{key}{_VSEP}{vid}"])
        except RadosError:
            pass  # no version index object / no such generation

    def versions_of(self, bucket: str, key: str) -> list[dict]:
        """Every generation of `key`, newest first (head included)."""
        out = []
        head = self._index(bucket).get(key)
        if head is not None:
            out.append(dict(head, is_latest=True))
        prefix = f"{key}{_VSEP}"
        for k, meta in self._verindex(bucket).items():
            if k.startswith(prefix):
                out.append(dict(meta, is_latest=False))
        out.sort(key=lambda m: -float(m.get("mtime", 0)))
        return out

    # ------------------------------------------------------------ objects
    def _striped(self, bucket: str, key: str,
                 vid: str | None = None) -> StripedObject:
        tag = key if vid in (None, "", "null") else f"{key}{_VSEP}{vid}"
        safe = hashlib.sha256(tag.encode()).hexdigest()[:24]
        return StripedObject(
            self.client, self.pool,
            _DATA_PREFIX.format(bucket=bucket, key=safe),
            FileLayout(stripe_unit=65536, stripe_count=4,
                       object_size=1 << 22))

    def put_object(self, bucket: str, key: str, body: bytes,
                   origin: str | None = None,
                   mtime: float | None = None,
                   version_id: str | None = None) -> str:
        """origin: the zone whose client caused this change (multisite
        sync applies peer changes with the PEER's zone so they are not
        replicated back — the no-ping-pong rule).  mtime: preserve the
        ORIGIN's timestamp on replicated applies, or LWW comparisons
        against later origin entries would judge them stale.
        version_id: multisite replays a peer's exact generation id; a
        fresh id is minted otherwise when the bucket is versioned."""
        self.check_bucket(bucket)
        versioned = self.versioning_enabled(bucket)
        old_head = self._index(bucket).get(key) if versioned else None
        if versioned:
            # versioned PUT keeps every generation (rgw_op.cc
            # versioning-enabled write path): the old head retires
            # into the version index, nothing is dropped
            if old_head is not None:
                self._verindex_set(bucket, key,
                                   old_head.get("version_id", "null"),
                                   old_head)
            vid = version_id or uuid.uuid4().hex[:16]
        else:
            # versioning OFF or SUSPENDED.  Suspended S3 semantics: the
            # new object REPLACES the null generation only — non-null
            # generations (from when versioning was enabled) and their
            # data must survive, so only null-addressed data may drop.
            head = self._index(bucket).get(key)
            if head is not None and head.get("version_id"):
                # non-null head retires untouched into the index
                self._verindex_set(bucket, key, head["version_id"],
                                   head)
            else:
                self._drop_object_data(bucket, key)  # replaces null
            # the retained-null record (if any) is being replaced
            self._verindex_rm(bucket, key, "null")
            vid = None
        so = self._striped(bucket, key, vid)
        if body:
            so.write(0, body)
        etag = hashlib.md5(body).hexdigest()
        mtime = time.time() if mtime is None else float(mtime)
        meta = {"size": len(body), "etag": etag, "mtime": mtime}
        if vid is not None:
            meta["version_id"] = vid
        self._index_set(bucket, key, meta)
        self._bilog_append(bucket, {"op": "put", "key": key,
                                    "etag": etag, "mtime": mtime,
                                    "version_id": vid or "",
                                    "zone": origin or self.zone})
        self._notify(bucket, "s3:ObjectCreated:Put", key, etag=etag,
                     size=len(body), version_id=vid or "")
        return etag

    def list_versions_xml(self, bucket: str, prefix: str = "") -> bytes:
        """GET /bucket?versions (ListVersionsResult)."""
        self.check_bucket(bucket)
        keys = sorted({k for k in self._index(bucket)} |
                      {k.split(_VSEP)[0] for k in self._verindex(bucket)})
        items = []
        for key in keys:
            if prefix and not key.startswith(prefix):
                continue
            for meta in self.versions_of(bucket, key):
                vid = meta.get("version_id", "null")
                latest = "true" if meta.get("is_latest") else "false"
                if meta.get("delete_marker"):
                    items.append(
                        f"<DeleteMarker><Key>{escape(key)}</Key>"
                        f"<VersionId>{vid}</VersionId>"
                        f"<IsLatest>{latest}</IsLatest></DeleteMarker>")
                else:
                    items.append(
                        f"<Version><Key>{escape(key)}</Key>"
                        f"<VersionId>{vid}</VersionId>"
                        f"<IsLatest>{latest}</IsLatest>"
                        f"<Size>{meta['size']}</Size>"
                        f"<ETag>&quot;{meta['etag']}&quot;</ETag>"
                        f"</Version>")
        return (f'<?xml version="1.0"?><ListVersionsResult>'
                f"<Name>{escape(bucket)}</Name>"
                f"{''.join(items)}</ListVersionsResult>").encode()

    # ---------------------------------------------------------- lifecycle
    def set_lifecycle(self, bucket: str, rules: list[dict]) -> None:
        """rules: [{id, prefix, days, noncurrent_days}] — the
        expiration slice of the reference's LC config (rgw_lc.h:579
        rule model)."""
        rec = self._bucket_rec(bucket)
        rec["lifecycle"] = list(rules)
        self._bucket_rec_set(bucket, rec)

    def get_lifecycle(self, bucket: str) -> list[dict]:
        return list(self._bucket_rec(bucket).get("lifecycle", []))

    def lc_process(self, now: float | None = None) -> dict:
        """One LC worker pass over every bucket (the RGWLC::process
        scheduled-daemon role): expire current objects past their rule
        age (versioned buckets get a delete marker, plain buckets a
        real delete) and permanently remove NONCURRENT generations past
        noncurrent_days.  Returns counters for observability."""
        now = time.time() if now is None else now
        expired = noncurrent = 0
        for bucket in list(self._buckets()):
            try:
                rules = self.get_lifecycle(bucket)
            except KeyError:
                continue
            for rule in rules:
                pfx = rule.get("prefix", "")
                days = rule.get("days")
                nc_days = rule.get("noncurrent_days")
                if days is not None:
                    cutoff = now - float(days) * 86400
                    for key, meta in list(self._index(bucket).items()):
                        if not key.startswith(pfx) \
                                or meta.get("delete_marker"):
                            continue
                        if float(meta.get("mtime", now)) < cutoff:
                            self.delete_object(bucket, key)
                            expired += 1
                if nc_days is not None:
                    cutoff = now - float(nc_days) * 86400
                    for k, meta in list(self._verindex(bucket).items()):
                        key, _, vid = k.partition(_VSEP)
                        if not key.startswith(pfx):
                            continue
                        if float(meta.get("mtime", now)) < cutoff:
                            self.delete_object(
                                bucket, key,
                                version_id=meta.get("version_id",
                                                    "null"))
                            noncurrent += 1
        return {"expired": expired, "noncurrent_removed": noncurrent}

    # ----------------------------------------------------- multisite bilog
    _BILOG_KEEP = 10_000

    def _bilog_append(self, bucket: str, entry: dict) -> None:
        with self._bilog_lock:
            seq = self._bilog_seq.get(bucket)
            if seq is None:
                seq = max((int(k) for k in self._bilog_raw(bucket)),
                          default=0)
            seq += 1
            self._bilog_seq[bucket] = seq
            self.client.omap_set(
                self.pool, _BILOG_OID.format(bucket=bucket),
                {f"{seq:016d}": pack_value(dict(entry, seq=seq))})
            if seq % 512 == 0:  # trim the tail so the log stays bounded
                dead = [k for k in self._bilog_raw(bucket)
                        if int(k) <= seq - self._BILOG_KEEP]
                if dead:
                    self.client.omap_rm(
                        self.pool, _BILOG_OID.format(bucket=bucket),
                        dead)

    def _bilog_raw(self, bucket: str) -> dict:
        try:
            return self.client.omap_get(
                self.pool, _BILOG_OID.format(bucket=bucket))
        except RadosError:
            return {}

    def bilog_since(self, bucket: str, marker: int,
                    limit: int = 1000) -> list[dict]:
        raw = self._bilog_raw(bucket)
        out = []
        for k in sorted(raw):
            if int(k) > marker:
                out.append(unpack_value(raw[k]))
                if len(out) >= limit:
                    break
        return out

    def _drop_object_data(self, bucket: str, key: str) -> None:
        """Remove whatever backs the current head: the plain striped
        object AND, for a manifest head, its part objects."""
        meta = self._index(bucket).get(key)
        if meta and meta.get("parts"):
            for n, _size in meta["parts"]:
                self._part_striped(bucket, meta["upload"], n).remove()
        self._striped(bucket, key).remove()

    # -------------------------------------------------- multipart uploads
    def _part_striped(self, bucket: str, upload_id: str,
                      part_no: int) -> StripedObject:
        return StripedObject(
            self.client, self.pool,
            _PART_PREFIX.format(bucket=bucket, upload=upload_id,
                                part=part_no),
            FileLayout(stripe_unit=65536, stripe_count=4,
                       object_size=1 << 22))

    def _uploads_oid(self, bucket: str) -> str:
        return _UPLOADS_OID.format(bucket=bucket)

    def initiate_multipart(self, bucket: str, key: str) -> str:
        """POST ?uploads (RGWInitMultipart): mint an upload id; parts
        accumulate against it until complete/abort."""
        self.check_bucket(bucket)
        upload_id = uuid.uuid4().hex
        self.client.omap_set(self.pool, self._uploads_oid(bucket),
                             {upload_id: pack_value({"key": key})})
        return upload_id

    def _upload_session(self, bucket: str, upload_id: str) -> dict:
        raw = self.client.omap_get(self.pool, self._uploads_oid(bucket))
        if upload_id not in raw:
            raise KeyError(upload_id)
        return {k: unpack_value(v) for k, v in raw.items()
                if k == upload_id or k.startswith(upload_id + ".")}

    def put_part(self, bucket: str, key: str, upload_id: str,
                 part_no: int, body: bytes) -> str:
        """UploadPart: each part is its own striped object and its own
        omap record — concurrent part uploads never contend."""
        self._upload_session(bucket, upload_id)  # NoSuchUpload check
        so = self._part_striped(bucket, upload_id, part_no)
        so.remove()  # re-upload of a part replaces it
        if body:
            so.write(0, body)
        etag = hashlib.md5(body).hexdigest()
        self.client.omap_set(
            self.pool, self._uploads_oid(bucket),
            {f"{upload_id}.{part_no:05d}":
             pack_value({"size": len(body), "etag": etag})})
        return etag

    def complete_multipart(self, bucket: str, key: str, upload_id: str,
                           parts: list[tuple[int, str]]) -> str:
        """CompleteMultipartUpload (RGWCompleteMultipart): validate the
        client's part list against what was stored, then publish a
        MANIFEST head — part data stays in the part objects, exactly the
        reference's manifest model (no copy)."""
        session = self._upload_session(bucket, upload_id)
        stored = {int(k.rsplit(".", 1)[1]): v
                  for k, v in session.items() if "." in k}
        if not parts:
            raise ValueError("empty part list")
        manifest, digests, total = [], b"", 0
        prev_n = 0
        for n, etag in sorted(parts):
            if n <= prev_n:  # S3 InvalidPartOrder: strictly ascending
                raise ValueError(f"duplicate/unordered part {n}")
            prev_n = n
            meta = stored.get(n)
            if meta is None or meta["etag"] != etag:
                raise ValueError(f"part {n} unknown or etag mismatch")
            manifest.append([n, meta["size"]])
            digests += bytes.fromhex(meta["etag"])
            total += meta["size"]
        # S3 multipart etag convention: md5 of the part digests, -N
        etag = f"{hashlib.md5(digests).hexdigest()}-{len(manifest)}"
        vid = None
        if self.versioning_enabled(bucket):
            # versioned completion retires the old head like any PUT
            # (generation retained, nothing dropped)
            old_head = self._index(bucket).get(key)
            if old_head is not None:
                self._verindex_set(bucket, key,
                                   old_head.get("version_id", "null"),
                                   old_head)
            vid = uuid.uuid4().hex[:16]
        else:
            self._drop_object_data(bucket, key)  # replace any old head
        mtime = time.time()
        meta = {"size": total, "etag": etag,
                "mtime": mtime, "parts": manifest,
                "upload": upload_id}
        if vid is not None:
            meta["version_id"] = vid
        self._index_set(bucket, key, meta)
        self._bilog_append(bucket, {"op": "put", "key": key,
                                    "etag": etag, "mtime": mtime,
                                    "version_id": vid or "",
                                    "zone": self.zone})
        self._notify(bucket,
                     "s3:ObjectCreated:CompleteMultipartUpload", key,
                     etag=etag, size=total, version_id=vid or "")
        # retire the session; uploaded-but-unlisted parts are garbage
        for n in stored:
            if n not in {p[0] for p in manifest}:
                self._part_striped(bucket, upload_id, n).remove()
        self.client.omap_rm(self.pool, self._uploads_oid(bucket),
                            [upload_id] + [f"{upload_id}.{n:05d}"
                                           for n in stored])
        return etag

    def abort_multipart(self, bucket: str, key: str,
                        upload_id: str) -> None:
        session = self._upload_session(bucket, upload_id)
        for k in session:
            if "." in k:
                n = int(k.rsplit(".", 1)[1])
                self._part_striped(bucket, upload_id, n).remove()
        self.client.omap_rm(self.pool, self._uploads_oid(bucket),
                            list(session))

    def list_parts_xml(self, bucket: str, key: str,
                       upload_id: str) -> bytes:
        session = self._upload_session(bucket, upload_id)
        items = []
        for k in sorted(session):
            if "." not in k:
                continue
            n = int(k.rsplit(".", 1)[1])
            meta = session[k]
            items.append(f"<Part><PartNumber>{n}</PartNumber>"
                         f"<Size>{meta['size']}</Size>"
                         f"<ETag>&quot;{meta['etag']}&quot;</ETag></Part>")
        return (f'<?xml version="1.0"?><ListPartsResult>'
                f"<Key>{escape(key)}</Key>"
                f"<UploadId>{upload_id}</UploadId>"
                f"{''.join(items)}</ListPartsResult>").encode()

    def list_uploads_xml(self, bucket: str) -> bytes:
        self.check_bucket(bucket)
        try:
            raw = self.client.omap_get(self.pool,
                                       self._uploads_oid(bucket))
        except RadosError:
            raw = {}
        items = []
        for k in sorted(raw):
            if "." in k:
                continue
            sess = unpack_value(raw[k])
            items.append(f"<Upload><Key>{escape(sess['key'])}</Key>"
                         f"<UploadId>{k}</UploadId></Upload>")
        return (f'<?xml version="1.0"?>'
                f"<ListMultipartUploadsResult>"
                f"<Bucket>{escape(bucket)}</Bucket>"
                f"{''.join(items)}"
                f"</ListMultipartUploadsResult>").encode()

    def head_object(self, bucket: str, key: str,
                    version_id: str | None = None) -> dict:
        self.check_bucket(bucket)
        if version_id:
            for meta in self.versions_of(bucket, key):
                if meta.get("version_id", "null") == version_id:
                    if meta.get("delete_marker"):
                        raise KeyError(key)
                    return meta
            raise KeyError(key)
        meta = self._index(bucket).get(key)
        if meta is None or meta.get("delete_marker"):
            raise KeyError(key)
        return meta

    def _read_extent(self, bucket: str, key: str, meta: dict,
                     start: int, length: int) -> bytes:
        """Read [start, start+length) of the head — directly for a plain
        object, stitched across part objects for a manifest head (the
        RGWObjManifest iterator role)."""
        if length <= 0:
            return b""
        if not meta.get("parts"):
            return self._striped(bucket, key,
                                 meta.get("version_id")).read(start,
                                                              length)
        out, pos = [], 0
        end = start + length
        for n, size in meta["parts"]:
            if pos + size <= start:
                pos += size
                continue
            if pos >= end:
                break
            lo = max(0, start - pos)
            hi = min(size, end - pos)
            out.append(self._part_striped(bucket, meta["upload"], n)
                       .read(lo, hi - lo))
            pos += size
        return b"".join(out)

    def get_object(self, bucket: str, key: str,
                   range_header: str | None = None,
                   version_id: str | None = None):
        meta = self.head_object(bucket, key, version_id=version_id)
        if range_header and range_header.startswith("bytes="):
            spec = range_header[len("bytes="):]
            start_s, _, end_s = spec.partition("-")
            if not start_s:
                # suffix range (RFC 7233): the LAST N bytes
                n = int(end_s)
                start = max(0, meta["size"] - n)
                end = meta["size"] - 1
            else:
                start = int(start_s)
                end = int(end_s) if end_s else meta["size"] - 1
            data = self._read_extent(bucket, key, meta, start,
                                     max(0, end - start + 1))
            return data, meta, 206
        return self._read_extent(bucket, key, meta, 0,
                                 meta["size"]), meta, 200

    def delete_object(self, bucket: str, key: str,
                      origin: str | None = None,
                      version_id: str | None = None,
                      mtime: float | None = None,
                      marker_version_id: str | None = None) -> dict:
        """S3 delete semantics (rgw_op.cc RGWDeleteObj versioned
        paths): on a versioned bucket an unqualified DELETE leaves a
        delete MARKER (data retained); versionId= permanently removes
        that one generation, promoting the next-newest to head when it
        was current.  Returns {delete_marker, version_id}."""
        self.check_bucket(bucket)
        mtime = time.time() if mtime is None else float(mtime)
        versioned = self.versioning_enabled(bucket)
        head = self._index(bucket).get(key)
        if versioned and not version_id:
            if head is None and not self.versions_of(bucket, key):
                raise KeyError(key)
            if head is not None:
                self._verindex_set(bucket, key,
                                   head.get("version_id", "null"),
                                   head)
            # multisite replays a peer's marker with the PEER's id so
            # generations stay identical across zones
            vid = marker_version_id or uuid.uuid4().hex[:16]
            self._index_set(bucket, key,
                            {"size": 0, "etag": "", "mtime": mtime,
                             "version_id": vid, "delete_marker": True})
            self._bilog_append(bucket, {"op": "delete_marker",
                                        "key": key, "etag": "",
                                        "mtime": mtime,
                                        "version_id": vid,
                                        "zone": origin or self.zone})
            self._notify(bucket,
                         "s3:ObjectRemoved:DeleteMarkerCreated", key,
                         version_id=vid)
            return {"delete_marker": True, "version_id": vid}
        if version_id:
            # permanent removal of ONE generation
            target = next((m for m in self.versions_of(bucket, key)
                           if m.get("version_id", "null") == version_id),
                          None)
            if target is None:
                raise KeyError(key)
            if not target.get("delete_marker") \
                    and not target.get("parts"):
                self._striped(bucket, key,
                              target.get("version_id")).remove()
            if head is not None and \
                    head.get("version_id", "null") == version_id:
                self._index_rm(bucket, key)
                rest = [m for m in self.versions_of(bucket, key)
                        if m.get("version_id", "null") != version_id]
                if rest:  # promote the next-newest generation
                    new_head = rest[0]
                    self._verindex_rm(bucket, key,
                                      new_head.get("version_id",
                                                   "null"))
                    self._index_set(bucket, key, new_head)
            else:
                self._verindex_rm(bucket, key, version_id)
            self._bilog_append(bucket, {"op": "delete_version",
                                        "key": key, "etag": "",
                                        "mtime": mtime,
                                        "version_id": version_id,
                                        "zone": origin or self.zone})
            self._notify(bucket, "s3:ObjectRemoved:Delete", key,
                         version_id=version_id)
            return {"delete_marker": False, "version_id": version_id}
        if head is None:
            raise KeyError(key)
        self._drop_object_data(bucket, key)
        self._index_rm(bucket, key)
        self._bilog_append(bucket, {"op": "delete", "key": key,
                                    "etag": "", "mtime": mtime,
                                    "version_id": "",
                                    "zone": origin or self.zone})
        self._notify(bucket, "s3:ObjectRemoved:Delete", key,
                     version_id=version_id or "")
        return {"delete_marker": False, "version_id": ""}
