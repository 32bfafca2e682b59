"""Typed configs, the train state and the noise source of a stochastic forward."""
