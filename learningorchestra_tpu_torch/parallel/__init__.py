"""Parallel layers of the port: the mixture-of-experts feed-forward
(:mod:`.moe`), on one card."""
