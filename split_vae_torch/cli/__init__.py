"""The training CLIs, flag-compatible with the reference's."""
