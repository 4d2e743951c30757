"""The plain reference the benchmark holds the port to: a frozen copy of the
port's plain route for one process (PointFoot env on table, plane or
procedural terrain, the fused decimation rollout through its plain
versions, the actor-critic networks, PPO and RecurrentPPO, one training
iteration).  Plain PyTorch; imports nothing of the port, of the JAX package
or of JAX.  Later changes to the port do not reach it."""
