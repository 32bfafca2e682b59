"""dot.notation dict (split_vae_tpu/utils/dotdict.py; the reference's
vae/utils.py:3-7, spair/utils.py:7-11).

The typed dataclass configs (core/config.py) are the port's configuration;
this class serves code written against the reference's config object,
including its quirk that a missing key reads as None instead of raising.
"""


class dotdict(dict):
    """dot.notation access to dictionary attributes; missing keys -> None."""

    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__
