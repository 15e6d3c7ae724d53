"""Percent of the HBM roofline the cost kernel's range reached
(``peaks.roofline_share``)."""

from ..peaks import roofline_share


def read(record):
    return roofline_share(record, "cost_obs")
