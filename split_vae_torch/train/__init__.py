"""Losses, schedules, optimizer and the train step."""
