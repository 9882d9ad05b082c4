"""The slice partitioner's handoff contract (the partitioner itself, with
MIG, is not ported yet)."""
