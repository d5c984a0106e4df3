"""Parallelism for the port: a mesh of ``torch.distributed`` ranks with
named-axis collectives (``mesh``), the sharding rules that map a model's
logical axes onto it (``sharding``), and the differentiable collectives of
the sharded train step (``collectives``)."""
