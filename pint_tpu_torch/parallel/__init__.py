"""Batching over pulsars (``pta.py``); the multi-GPU mesh is ROADMAP A8."""
