"""Parallelism for the port: a mesh of ``torch.distributed`` ranks with
named-axis collectives (``mesh``) and the sharding rules that map a model's
logical axes onto it (``sharding``)."""
