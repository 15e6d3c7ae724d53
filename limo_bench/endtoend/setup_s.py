"""Seconds from the process's start to the first timed frame: inputs,
configuration, kernel build, warm-up."""


def read(record):
    return record.setup_s
