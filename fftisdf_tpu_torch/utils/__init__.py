"""Device policy and the ISDF state on disk."""
