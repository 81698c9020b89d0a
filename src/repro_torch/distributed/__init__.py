"""Multi-device execution: the logical-axis rule tables (``sharding``)."""
