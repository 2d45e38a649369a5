"""Training: optimizer, schedules and train steps."""
