"""Training: the 3-group optimizer with its schedules, the train state and
step, and the trainer."""
