"""Collectives of the sharded superstep (``collectives``) and the margin
merge with optional wire compression (``compress.psum_compressed``)."""
