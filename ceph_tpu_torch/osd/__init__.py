"""OSD data plane (the reference's src/os + src/osd layers, SURVEY.md
§2.5-2.6).  The port holds the three modules the control plane needs:
the op scheduler (``scheduler``), per-pool compression options
(``compression``) and past intervals (``intervals``); the object stores,
PGs, backends and the daemon are not ported yet."""
