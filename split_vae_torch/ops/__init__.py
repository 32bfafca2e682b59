"""Numerical primitives: distributions, STN crop and paste, patch scramble, count prior."""
