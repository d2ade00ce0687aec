"""Run-time helpers of the trainer."""
