"""Control plane: cluster maps, the monitor, failure detection
(the reference's src/mon layer, SURVEY.md §2.4)."""
