"""Probes of the card: K6/K7 (overlap.py)."""
