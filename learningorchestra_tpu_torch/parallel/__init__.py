"""Parallel layers of the port: the mixture-of-experts feed-forward
(:mod:`.moe`, on one card), ring and Ulysses sequence-parallel attention
over a pod's ``sp`` ranks (:mod:`.ring`, :mod:`.ulysses`) and the
sharding rules (:mod:`.sharding`)."""
