"""Time of a stream session's initialization (``engine.initialize_imu``'s
VI initialization, or ``engine.initialize``) in the span slice
(``portbench/spans.py``): the host start of the program's ``vio.init``
span to its closing device stamp, so it runs to the card's completion of
the work, in ms."""
from portbench import spans


def read(s):
    return spans.fill(s).get("init_ms")
