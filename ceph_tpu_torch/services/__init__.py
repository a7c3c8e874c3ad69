"""Service layers over RADOS (the reference's librbd/rgw/cephfs tier).

The JAX package's services, each on the port's client: ``rbd`` (block
images striped over objects with COW snapshots, the journal and the
object map) with its two block gateways, ``nbd`` and ``nvmeof``;
``mds`` and ``fs`` (the metadata server with its journal, multi-active
ranks and standby-replay, and the file client with ``.snap`` views) and
``smb``, a share over ``fs``; ``rgw``, the S3-dialect gateway, with
``s3auth``, its SigV4 signer and verifier, and ``multisite``, the zone
sync agent between two gateways.
"""
