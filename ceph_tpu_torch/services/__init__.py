"""Service layers over RADOS (the reference's librbd/rgw/cephfs tier).

Ported so far: ``rgw`` — the S3-dialect gateway (bucket index in omap,
object data striped) — and ``s3auth``, its SigV4 signer and verifier,
which the saturation harness's ``--frontend rgw`` leg drives.
"""
