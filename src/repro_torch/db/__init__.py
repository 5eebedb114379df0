"""RemixDB's store layer; so far the in-memory partitions and the clock."""
