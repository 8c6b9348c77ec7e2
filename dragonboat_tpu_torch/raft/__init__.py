"""Host-side raft helpers the quorum coordinator reaches.

Counterpart: ``dragonboat_tpu/raft/``; only what the coordinator calls is
copied here so far.
"""
