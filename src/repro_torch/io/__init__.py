"""On-disk persistence; so far the incremental REMIX rebuild."""
