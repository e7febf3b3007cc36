"""Distributed runtime (counterpart of ``paddle_tpu/distributed``). The
port has ``faults``, the deterministic fault injection that the
checkpoint writer's ``checkpoint.write`` point and the checkpointable
reader's ``reader.next`` point fire; the rest waits for ROADMAP queue 1
item 8."""
