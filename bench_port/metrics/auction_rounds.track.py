"""Bidding rounds the auction runs a window, from the program's counter
``auction_lap.rounds`` over a traced run's span windows."""

SOURCE, UNIT, BETTER = "program_counter", "rounds", "lower"
LAYER, MOVES = "association", "track_fps"


def read(ctx):
    r = ctx["rounds"]
    return sum(r) / len(r) if r else None
