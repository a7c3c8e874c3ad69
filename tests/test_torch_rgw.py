"""The port's S3 gateway (ceph_tpu_torch.services.rgw) and its SigV4
signer (services/s3auth.py).

The JAX package's tests/test_rgw.py on the port (less its multisite
case, which waits for services.multisite), then the port against the
reference: SigV4 signatures equal both ways on seeded requests, and the
same PUT, multipart and GET sequence leaves the same RADOS objects,
bytes, xattrs and omap on a port cluster as on a reference cluster.
"""

import http.client

import numpy as np
import pytest

from ceph_tpu_torch.services.rgw import RgwGateway
from ceph_tpu_torch.tools.vstart import MiniCluster
from tests.test_torch_cluster import make_cfg

RNG = np.random.default_rng(66)


@pytest.fixture
def gateway():
    c = MiniCluster(n_osds=6, cfg=make_cfg()).start()
    client = c.client()
    client.create_pool("rgw", size=3, pg_num=2)
    gw = RgwGateway(client, "rgw")
    yield c, gw
    gw.stop()
    c.stop()


def _req(gw, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=10)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, data, dict(resp.getheaders()))
    conn.close()
    return out


def test_bucket_lifecycle(gateway):
    _c, gw = gateway
    st, body, _ = _req(gw, "GET", "/")
    assert st == 200 and b"<Buckets></Buckets>" in body
    assert _req(gw, "PUT", "/photos")[0] == 200
    assert _req(gw, "HEAD", "/photos")[0] == 200
    st, body, _ = _req(gw, "GET", "/")
    assert b"<Name>photos</Name>" in body
    # unknown bucket 404s
    assert _req(gw, "GET", "/nope")[0] == 404
    assert _req(gw, "PUT", "/photos/x.bin", body=b"abc")[0] == 200
    # non-empty bucket refuses deletion
    assert _req(gw, "DELETE", "/photos")[0] == 409
    assert _req(gw, "DELETE", "/photos/x.bin")[0] == 204
    assert _req(gw, "DELETE", "/photos")[0] == 204
    assert _req(gw, "HEAD", "/photos")[0] == 404


def test_object_put_get_roundtrip_and_etag(gateway):
    _c, gw = gateway
    _req(gw, "PUT", "/b")
    data = RNG.integers(0, 256, 5_000_000, dtype=np.uint8).tobytes()
    st, _, hdrs = _req(gw, "PUT", "/b/big/nested/key.bin", body=data)
    assert st == 200
    import hashlib
    assert hdrs["ETag"].strip('"') == hashlib.md5(data).hexdigest()
    st, body, hdrs = _req(gw, "GET", "/b/big/nested/key.bin")
    assert st == 200 and body == data
    st, _, hdrs = _req(gw, "HEAD", "/b/big/nested/key.bin")
    assert st == 200 and hdrs["X-Object-Size"] == str(len(data))
    # replace changes etag and content
    st, _, _ = _req(gw, "PUT", "/b/big/nested/key.bin", body=b"short")
    st, body, _ = _req(gw, "GET", "/b/big/nested/key.bin")
    assert body == b"short"


def test_range_get(gateway):
    _c, gw = gateway
    _req(gw, "PUT", "/b")
    data = RNG.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    _req(gw, "PUT", "/b/obj", body=data)
    st, body, _ = _req(gw, "GET", "/b/obj",
                       headers={"Range": "bytes=100000-100999"})
    assert st == 206 and body == data[100_000:101_000]
    st, body, _ = _req(gw, "GET", "/b/obj",
                       headers={"Range": "bytes=299990-"})
    assert st == 206 and body == data[299_990:]


def test_listing_with_prefix(gateway):
    _c, gw = gateway
    _req(gw, "PUT", "/b")
    for key in ("logs/a", "logs/b", "data/c"):
        _req(gw, "PUT", f"/b/{key}", body=key.encode())
    st, body, _ = _req(gw, "GET", "/b")
    for key in ("logs/a", "logs/b", "data/c"):
        assert f"<Key>{key}</Key>".encode() in body
    st, body, _ = _req(gw, "GET", "/b?prefix=logs/")
    assert b"<Key>logs/a</Key>" in body and b"data/c" not in body


def test_objects_survive_osd_failure(gateway):
    c, gw = gateway
    _req(gw, "PUT", "/b")
    data = RNG.integers(0, 256, 1_000_000, dtype=np.uint8).tobytes()
    _req(gw, "PUT", "/b/durable", body=data)
    victim = sorted(c.osds)[0]
    epoch = c.mon.osdmap.epoch
    c.kill_osd(victim)
    c.wait_for_epoch(epoch + 1)
    c.settle(0.8)
    st, body, _ = _req(gw, "GET", "/b/durable")
    assert st == 200 and body == data


def test_suffix_range_and_encoded_keys(gateway):
    _c, gw = gateway
    _req(gw, "PUT", "/b")
    data = RNG.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    # percent-encoded key round-trips DECODED
    _req(gw, "PUT", "/b/my%20file.txt", body=data)
    st, body, _ = _req(gw, "GET", "/b/my%20file.txt")
    assert st == 200 and body == data
    st, body, _ = _req(gw, "GET", "/b")
    assert b"<Key>my file.txt</Key>" in body
    # suffix range = LAST N bytes (RFC 7233)
    st, body, _ = _req(gw, "GET", "/b/my%20file.txt",
                       headers={"Range": "bytes=-500"})
    assert st == 206 and body == data[-500:]


# ------------------------------------------------------------ SigV4 auth
@pytest.fixture
def auth_gateway():
    from ceph_tpu_torch.services import s3auth
    c = MiniCluster(n_osds=4, cfg=make_cfg()).start()
    client = c.client()
    client.create_pool("rgw", size=3, pg_num=2)
    gw = RgwGateway(client, "rgw", users={"AKIATEST": "sekrit"})
    yield gw, s3auth
    gw.stop()
    c.stop()


def _signed(gw, s3auth, method, path_qs, body=b"", access="AKIATEST",
            secret="sekrit"):
    path, _, query = path_qs.partition("?")
    headers = s3auth.sign(method, f"127.0.0.1:{gw.port}", path, query,
                          body, access, secret)
    return _req(gw, method, path_qs, body=body or None, headers=headers)


def test_sigv4_rejects_anonymous_and_bad_secret(auth_gateway):
    gw, s3auth = auth_gateway
    st, body, _ = _req(gw, "PUT", "/b")
    assert st == 403 and b"AccessDenied" in body
    st, body, _ = _signed(gw, s3auth, "PUT", "/b", secret="wrong")
    assert st == 403 and b"SignatureDoesNotMatch" in body
    st, body, _ = _signed(gw, s3auth, "PUT", "/b", access="AKIANOPE",
                          secret="sekrit")
    assert st == 403 and b"InvalidAccessKeyId" in body


def test_sigv4_accepts_valid_requests(auth_gateway):
    gw, s3auth = auth_gateway
    assert _signed(gw, s3auth, "PUT", "/b")[0] == 200
    assert _signed(gw, s3auth, "PUT", "/b/k%20ey.bin",
                   body=b"hello")[0] == 200
    st, data, _ = _signed(gw, s3auth, "GET", "/b/k%20ey.bin")
    assert (st, data) == (200, b"hello")
    # tampered body fails the payload-hash check
    path, _, query = "/b/k2".partition("?")
    headers = s3auth.sign("PUT", f"127.0.0.1:{gw.port}", path, query,
                          b"signed-body", "AKIATEST", "sekrit")
    st, body, _ = _req(gw, "PUT", "/b/k2", body=b"other-body",
                       headers=headers)
    assert st == 400 and b"XAmzContentSHA256Mismatch" in body


# ------------------------------------------------------------- multipart
def test_multipart_upload_lifecycle(gateway):
    _c, gw = gateway
    _req(gw, "PUT", "/mp")
    # initiate
    st, body, _ = _req(gw, "POST", "/mp/big.bin?uploads")
    assert st == 200
    upload_id = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0] \
        .decode()
    # three parts, re-uploading part 2 once (replace semantics)
    p1 = RNG.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    p2 = RNG.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    p3 = b"tail" * 1000
    etags = {}
    _req(gw, "PUT", f"/mp/big.bin?partNumber=2&uploadId={upload_id}",
         body=b"garbage-first-try")
    for n, p in ((1, p1), (2, p2), (3, p3)):
        st, _, hdrs = _req(
            gw, "PUT", f"/mp/big.bin?partNumber={n}&uploadId={upload_id}",
            body=p)
        assert st == 200
        etags[n] = hdrs["ETag"].strip('"')
    # ListParts shows all three
    st, body, _ = _req(gw, "GET", f"/mp/big.bin?uploadId={upload_id}")
    assert st == 200 and body.count(b"<Part>") == 3
    # object invisible until complete
    assert _req(gw, "HEAD", "/mp/big.bin")[0] == 404
    # complete
    xml = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>\"{etags[n]}\"</ETag>"
        f"</Part>" for n in (1, 2, 3)) + "</CompleteMultipartUpload>"
    st, body, _ = _req(gw, "POST", f"/mp/big.bin?uploadId={upload_id}",
                       body=xml.encode())
    assert st == 200 and b"-3" in body  # S3 multipart etag suffix
    # manifest read: whole and ranged across part boundaries
    st, data, _ = _req(gw, "GET", "/mp/big.bin")
    assert st == 200 and data == p1 + p2 + p3
    st, data, _ = _req(gw, "GET", "/mp/big.bin",
                       headers={"Range": "bytes=299000-301000"})
    assert st == 206 and data == (p1 + p2 + p3)[299000:301001]
    # delete removes parts + index
    assert _req(gw, "DELETE", "/mp/big.bin")[0] == 204
    assert _req(gw, "GET", "/mp/big.bin")[0] == 404


def test_multipart_abort_and_bad_complete(gateway):
    _c, gw = gateway
    _req(gw, "PUT", "/mp2")
    st, body, _ = _req(gw, "POST", "/mp2/x?uploads")
    upload_id = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0] \
        .decode()
    _req(gw, "PUT", f"/mp2/x?partNumber=1&uploadId={upload_id}",
         body=b"part-one")
    # listing shows the in-flight upload
    st, body, _ = _req(gw, "GET", "/mp2?uploads")
    assert st == 200 and upload_id.encode() in body
    # complete with a wrong etag fails and publishes nothing
    xml = ('<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>'
           '<ETag>"beef"</ETag></Part></CompleteMultipartUpload>')
    st, body, _ = _req(gw, "POST", f"/mp2/x?uploadId={upload_id}",
                       body=xml.encode())
    assert st == 400 and _req(gw, "HEAD", "/mp2/x")[0] == 404
    # abort retires the session
    assert _req(gw, "DELETE", f"/mp2/x?uploadId={upload_id}")[0] == 204
    st, body, _ = _req(gw, "GET", "/mp2?uploads")
    assert upload_id.encode() not in body
    # completing an aborted upload 404s
    st, _, _ = _req(gw, "POST", f"/mp2/x?uploadId={upload_id}",
                    body=xml.encode())
    assert st == 404


def test_sigv4_rejects_stale_date(auth_gateway):
    import datetime
    gw, s3auth = auth_gateway
    old = datetime.datetime.now(datetime.timezone.utc) \
        - datetime.timedelta(hours=2)
    headers = s3auth.sign("PUT", f"127.0.0.1:{gw.port}", "/b", "",
                          b"", "AKIATEST", "sekrit", now=old)
    st, body, _ = _req(gw, "PUT", "/b", headers=headers)
    assert st == 403 and b"RequestTimeTooSkewed" in body


def test_multipart_rejects_duplicate_parts(gateway):
    _c, gw = gateway
    _req(gw, "PUT", "/mpd")
    st, body, _ = _req(gw, "POST", "/mpd/x?uploads")
    upload_id = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0] \
        .decode()
    st, _, hdrs = _req(gw, "PUT",
                       f"/mpd/x?partNumber=1&uploadId={upload_id}",
                       body=b"dup")
    etag = hdrs["ETag"].strip('"')
    xml = ("<CompleteMultipartUpload>" +
           f'<Part><PartNumber>1</PartNumber><ETag>"{etag}"</ETag></Part>'
           * 2 + "</CompleteMultipartUpload>")
    st, body, _ = _req(gw, "POST", f"/mpd/x?uploadId={upload_id}",
                       body=xml.encode())
    assert st == 400 and _req(gw, "HEAD", "/mpd/x")[0] == 404


def test_sigv4_header_names_case_insensitive(auth_gateway):
    """Standard clients send 'X-Amz-Date' / 'X-Amz-Content-SHA256'
    (botocore casing); the verifier must match header names
    case-insensitively like rgw_auth_s3.cc (ADVICE r2)."""
    gw, s3auth = auth_gateway
    path, body = "/b/cased", b"payload"
    assert _signed(gw, s3auth, "PUT", "/b")[0] == 200
    headers = s3auth.sign("PUT", f"127.0.0.1:{gw.port}", path, "",
                          body, "AKIATEST", "sekrit")
    recased = {{"x-amz-date": "X-Amz-Date",
                "x-amz-content-sha256": "X-Amz-Content-SHA256"}
               .get(k.lower(), k): v for k, v in headers.items()}
    assert "X-Amz-Date" in recased and "Authorization" in recased
    st, _, _ = _req(gw, "PUT", path, body=body, headers=recased)
    assert st == 200


def test_object_versioning(gateway):
    """S3 versioning semantics (rgw_op.cc versioned paths): every PUT
    keeps a generation, unqualified DELETE leaves a marker, versionId=
    addresses and permanently removes specific generations."""
    _c, gw = gateway
    _req(gw, "PUT", "/vb")
    body = ('<VersioningConfiguration><Status>Enabled</Status>'
            '</VersioningConfiguration>')
    assert _req(gw, "PUT", "/vb?versioning", body=body)[0] == 200
    st, resp, _ = _req(gw, "GET", "/vb?versioning")
    assert st == 200 and b"<Status>Enabled</Status>" in resp
    # two generations
    _req(gw, "PUT", "/vb/doc", body=b"generation-one")
    _req(gw, "PUT", "/vb/doc", body=b"generation-TWO")
    st, data, _ = _req(gw, "GET", "/vb/doc")
    assert st == 200 and data == b"generation-TWO"
    vs = gw.versions_of("vb", "doc")
    assert len(vs) == 2 and vs[0]["is_latest"]
    old_vid = vs[1]["version_id"]
    # address the old generation explicitly
    st, data, _ = _req(gw, "GET", f"/vb/doc?versionId={old_vid}")
    assert st == 200 and data == b"generation-one"
    # unqualified delete -> marker; GET 404; versions list shows it
    st, _d, hdrs = _req(gw, "DELETE", "/vb/doc")
    assert st == 204 and hdrs.get("x-amz-delete-marker") == "true"
    assert _req(gw, "GET", "/vb/doc")[0] == 404
    st, xml, _ = _req(gw, "GET", "/vb?versions")
    assert b"<DeleteMarker>" in xml and xml.count(b"<Version>") == 2
    # old generation still readable by id
    st, data, _ = _req(gw, "GET", f"/vb/doc?versionId={old_vid}")
    assert st == 200 and data == b"generation-one"
    # delete the marker -> previous generation becomes current again
    marker_vid = next(m["version_id"] for m in gw.versions_of("vb", "doc")
                      if m.get("delete_marker"))
    assert _req(gw, "DELETE",
                f"/vb/doc?versionId={marker_vid}")[0] == 204
    st, data, _ = _req(gw, "GET", "/vb/doc")
    assert st == 200 and data == b"generation-TWO"
    # permanently remove a specific old generation
    assert _req(gw, "DELETE",
                f"/vb/doc?versionId={old_vid}")[0] == 204
    assert _req(gw, "GET", f"/vb/doc?versionId={old_vid}")[0] == 404
    assert len(gw.versions_of("vb", "doc")) == 1


def test_lifecycle_expiration(gateway):
    """LC worker pass (rgw_lc.h role): current objects past their rule
    age expire; noncurrent generations past noncurrent_days purge."""
    import time as _time
    _c, gw = gateway
    _req(gw, "PUT", "/lcb")
    gw.set_versioning("lcb", True)
    gw.put_object("lcb", "logs/old", b"ancient",
                  mtime=_time.time() - 10 * 86400)
    gw.put_object("lcb", "logs/old", b"newer-generation")
    gw.put_object("lcb", "keep/fresh", b"fresh")
    body = ('<LifecycleConfiguration><Rule><ID>r1</ID>'
            '<Prefix>logs/</Prefix>'
            '<Expiration><Days>30</Days></Expiration>'
            '<NoncurrentVersionExpiration><NoncurrentDays>7'
            '</NoncurrentDays></NoncurrentVersionExpiration>'
            '</Rule></LifecycleConfiguration>')
    assert _req(gw, "PUT", "/lcb?lifecycle", body=body)[0] == 200
    assert gw.get_lifecycle("lcb")[0]["prefix"] == "logs/"
    # noncurrent "ancient" generation is 10 days old -> purged;
    # the current generation is fresh -> stays
    res = gw.lc_process()
    assert res["noncurrent_removed"] == 1 and res["expired"] == 0
    assert len(gw.versions_of("lcb", "logs/old")) == 1
    assert _req(gw, "GET", "/lcb/logs/old")[1] == b"newer-generation"
    # age the current generation past 30 days -> marker on next pass
    meta = gw._index("lcb")["logs/old"]
    meta["mtime"] = _time.time() - 31 * 86400
    gw._index_set("lcb", "logs/old", meta)
    res = gw.lc_process()
    assert res["expired"] == 1
    assert _req(gw, "GET", "/lcb/logs/old")[0] == 404
    assert _req(gw, "GET", "/lcb/keep/fresh")[0] == 200


@pytest.fixture
def iam_gateway():
    from ceph_tpu_torch.services import s3auth
    c = MiniCluster(n_osds=4, cfg=make_cfg()).start()
    client = c.client()
    client.create_pool("rgw", size=3, pg_num=2)
    gw = RgwGateway(client, "rgw", users={"ALICE": "s1", "BOB": "s2",
                                          "EVE": "s3"})
    yield gw, s3auth
    gw.stop()
    c.stop()


def test_iam_bucket_ownership_and_policy(iam_gateway):
    """The rgw IAM/bucket-policy slice (rgw_iam_policy role): buckets
    are owned; non-owners need a policy grant; Deny beats Allow;
    config verbs stay owner-only."""
    import json as _json
    gw, s3auth = iam_gateway

    def alice(method, path, body=b""):
        return _signed(gw, s3auth, method, path, body,
                       access="ALICE", secret="s1")

    def bob(method, path, body=b""):
        return _signed(gw, s3auth, method, path, body,
                       access="BOB", secret="s2")

    def eve(method, path, body=b""):
        return _signed(gw, s3auth, method, path, body,
                       access="EVE", secret="s3")

    assert alice("PUT", "/priv")[0] == 200
    assert gw.bucket_owner("priv") == "ALICE"
    assert alice("PUT", "/priv/doc", b"owner-data")[0] == 200
    # a non-owner is denied everything by default
    assert bob("GET", "/priv/doc")[0] == 403
    assert bob("PUT", "/priv/x", b"nope")[0] == 403
    assert bob("DELETE", "/priv/doc")[0] == 403
    assert bob("GET", "/priv")[0] == 403
    # the owner attaches a policy granting BOB read, EVE denied all
    policy = {"Statement": [
        {"Effect": "Allow", "Principal": {"AWS": ["BOB"]},
         "Action": ["s3:GetObject", "s3:ListBucket"]},
        {"Effect": "Deny", "Principal": {"AWS": ["EVE"]},
         "Action": ["s3:*"]},
    ]}
    assert alice("PUT", "/priv?policy",
                 _json.dumps(policy).encode())[0] == 200
    st, body, _ = alice("GET", "/priv?policy")
    assert st == 200 and _json.loads(body) == policy
    # BOB reads but cannot write; EVE is denied even reads
    assert bob("GET", "/priv/doc")[1] == b"owner-data"
    assert bob("GET", "/priv")[0] == 200
    assert bob("PUT", "/priv/x", b"still-nope")[0] == 403
    assert eve("GET", "/priv/doc")[0] == 403
    # non-owners cannot touch bucket config or the policy itself
    assert bob("PUT", "/priv?policy", b"{}")[0] == 403
    assert bob("PUT", "/priv?versioning",
               b"<VersioningConfiguration><Status>Enabled</Status>"
               b"</VersioningConfiguration>")[0] == 403
    assert bob("DELETE", "/priv")[0] == 403
    # wildcard principal opens reads to every authenticated user
    policy["Statement"][0]["Principal"] = "*"
    assert alice("PUT", "/priv?policy",
                 _json.dumps(policy).encode())[0] == 200
    assert bob("GET", "/priv/doc")[0] == 200
    assert eve("GET", "/priv/doc")[0] == 403  # Deny still wins
    # owner removes the policy: back to owner-only
    assert alice("DELETE", "/priv?policy")[0] == 204
    assert bob("GET", "/priv/doc")[0] == 403
    assert alice("GET", "/priv/doc")[1] == b"owner-data"
    # bucket re-PUT by a non-owner must neither hijack ownership nor
    # clobber config
    assert bob("PUT", "/priv")[0] == 403
    assert gw.bucket_owner("priv") == "ALICE"
    assert alice("PUT", "/priv")[0] == 200  # own re-PUT: no-op
    assert gw.bucket_owner("priv") == "ALICE"
    # config READS are owner-only; the admin bilog needs list rights
    assert bob("GET", "/priv?policy")[0] == 403
    assert bob("GET", "/priv?lifecycle")[0] == 403
    assert bob("GET", "/admin/bilog?bucket=priv")[0] == 403
    assert alice("GET", "/admin/bilog?bucket=priv")[0] == 200


# ------------------------------------------------ the port against the JAX package
import datetime  # noqa: E402
import itertools  # noqa: E402
import random  # noqa: E402
import time as _time  # noqa: E402
import types  # noqa: E402

from ceph_tpu.services import rgw as ref_rgw  # noqa: E402
from ceph_tpu.services import s3auth as ref_s3auth  # noqa: E402
from ceph_tpu.tools.vstart import MiniCluster as RefMiniCluster  # noqa: E402
from ceph_tpu_torch.services import rgw as port_rgw  # noqa: E402
from ceph_tpu_torch.services import s3auth as port_s3auth  # noqa: E402
from tests.test_cluster import make_cfg as ref_make_cfg  # noqa: E402


def _requests(seed: int, n: int = 24):
    """Seeded SigV4 requests: method, host, path, query, body, keys,
    region and a time within the verifier's skew window."""
    rng = random.Random(seed)
    now = datetime.datetime.now(datetime.timezone.utc)
    for _ in range(n):
        key = "".join(rng.choice("abc/ _-%.~") for _ in range(
            rng.randrange(1, 12)))
        query = "&".join(f"{rng.choice(['x', 'uploadId', 'partNumber'])}="
                         f"{rng.randrange(100)}"
                         for _ in range(rng.randrange(0, 3)))
        yield dict(method=rng.choice(["GET", "PUT", "POST", "DELETE",
                                      "HEAD"]),
                   host=f"127.0.0.1:{rng.randrange(1024, 65535)}",
                   path="/bkt/" + key, query=query,
                   body=rng.randbytes(rng.randrange(0, 300)),
                   access_key=f"AKIA{rng.randrange(10**6):06d}",
                   secret_key=rng.randbytes(12).hex(),
                   region=rng.choice(["us-east-1", "default"]),
                   now=now - datetime.timedelta(
                       seconds=rng.randrange(0, 600)))


@pytest.mark.parametrize("seed", [1, 2])
def test_sigv4_signatures_equal_both_ways(seed):
    """Equal headers from the same request, and each package verifies
    the other's signature (and refuses it under another secret)."""
    for req in _requests(seed):
        hp, hr = port_s3auth.sign(**req), ref_s3auth.sign(**req)
        assert hp == hr
        for signer, verifier in ((hp, ref_s3auth), (hr, port_s3auth)):
            assert verifier.verify(
                req["method"], req["path"], req["query"], signer,
                req["body"], {req["access_key"]: req["secret_key"]}.get
            ) == req["access_key"]
            with pytest.raises(verifier.AuthError):
                verifier.verify(req["method"], req["path"], req["query"],
                                signer, req["body"],
                                lambda _k: "another-secret")


def _pinned(monkeypatch, module, seed: int):
    """``module``'s clock fixed and its uuid4 a seeded sequence, so two
    gateways that make the same calls write the same bytes."""
    clock = types.SimpleNamespace(
        **{k: getattr(_time, k) for k in dir(_time) if not k.startswith("_")})
    clock.time = lambda: 1_760_000_000.0
    monkeypatch.setattr(module, "time", clock)
    counter = itertools.count()
    fake_uuid = types.SimpleNamespace(uuid4=lambda: types.SimpleNamespace(
        hex=f"{seed:08x}{next(counter):024x}"))
    monkeypatch.setattr(module, "uuid", fake_uuid)


def _rgw_session(gw) -> dict:
    """One PUT, multipart and GET sequence; returns what each GET and
    listing gave."""
    rng = np.random.default_rng(4242)
    small = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    big = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    parts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (70_000, 5)]
    gw.create_bucket("bkt")
    gw.put_object("bkt", "small", small)
    gw.put_object("bkt", "dir/big.bin", big)
    upload = gw.initiate_multipart("bkt", "mp.bin")
    etags = [gw.put_part("bkt", "mp.bin", upload, i + 1, p)
             for i, p in enumerate(parts)]
    gw.complete_multipart("bkt", "mp.bin", upload,
                          [(i + 1, e) for i, e in enumerate(etags)])
    got = {k: gw.get_object("bkt", k)[0]
           for k in ("small", "dir/big.bin", "mp.bin")}
    assert got == {"small": small, "dir/big.bin": big,
                   "mp.bin": b"".join(parts)}
    ranged = gw.get_object("bkt", "mp.bin", "bytes=69990-70003")[0]
    assert ranged == b"".join(parts)[69990:70004]
    return {"listing": gw.list_objects_xml("bkt"), "ranged": ranged}


def _rados_state(client, pool: str) -> dict:
    return {oid: (client.read(pool, oid), client.getxattrs(pool, oid),
                  client.omap_get(pool, oid))
            for oid in sorted(client.list_objects(pool))}


def test_gateway_leaves_the_references_rados_state(monkeypatch):
    """The same gateway calls on a port cluster and on a reference
    cluster: equal answers, and the same RADOS object names, bytes,
    xattrs and omap in the gateway's pool."""
    out = {}
    for name, mod, cluster, cfg in (
            ("port", port_rgw, MiniCluster, make_cfg),
            ("ref", ref_rgw, RefMiniCluster, ref_make_cfg)):
        _pinned(monkeypatch, mod, seed=7)
        c = cluster(n_osds=4, cfg=cfg()).start()
        try:
            client = c.client()
            client.create_pool("rgw", size=3, pg_num=2)
            gw = mod.RgwGateway(client, "rgw")
            try:
                answers = _rgw_session(gw)
            finally:
                gw.stop()
            out[name] = (answers, _rados_state(client, "rgw"))
        finally:
            c.stop()
    (port_answers, port_state), (ref_answers, ref_state) = \
        out["port"], out["ref"]
    assert port_answers == ref_answers
    assert list(port_state) == list(ref_state)
    assert len(port_state) >= 6
    for oid in ref_state:
        assert port_state[oid] == ref_state[oid], oid
