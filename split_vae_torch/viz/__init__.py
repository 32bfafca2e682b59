"""The PNG artifacts of the eval steps, written with numpy and the stdlib alone."""
