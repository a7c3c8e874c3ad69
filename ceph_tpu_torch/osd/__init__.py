"""OSD data plane: object stores, transactions, PGs, backends, daemons
(the reference's src/os + src/osd layers, SURVEY.md §2.5-2.6), on the
torch backend's kernels for EC pools."""
