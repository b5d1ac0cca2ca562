"""Entry points of the port: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.dryrun``; the multi-device launch
(``distributed_init``, ``mesh``, ``sharding``, ``specs``)."""
