"""MIL over precomputed tile features: the bag datasets, the feature
registry and the head's training loop (``tpuwsi/mil``)."""
