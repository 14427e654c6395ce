"""Distributed-execution support for the port. So far only
:mod:`repro_torch.dist.fault`: straggler monitoring, failure injection and
restart supervision (a copy of the JAX package's ``dist/fault.py``, which
touches no device state)."""
