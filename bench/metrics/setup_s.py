"""Process start -> the window opens (host clock): loading, weights made
on the card, index and engine built, every shape warmed."""


def read(run):
    return run.setup_s
