"""Losses: the detection loss (with the target padding the loader needs) and the
representation-learning losses."""
