"""Losses (so far only the target padding that the loader needs)."""
