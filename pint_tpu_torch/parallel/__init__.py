"""Batching over pulsars (``pta.py``) and the blocked dense factorization
on one device (``dense.py``); the multi-GPU mesh is ROADMAP A8."""
