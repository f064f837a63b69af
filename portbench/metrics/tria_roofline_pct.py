"""Share of the card's roofline in the QR triangularizations of a replayed
square-root-form step: the least time of the step's QRs
(``roofline/tria.py``: 2 m n² − ⅔ n³ operations and m n + n² / 2 words
for every pre-array the step factors at the configuration's slots, at the
published HBM and f32 peaks) over their device time, the ``vio.tria.*``
stamps that ``tria_replay_ms.offline`` reads, in %.  Nothing to read
without those spans or a card whose peaks are known."""
from portbench import spans
from portbench.roofline import tria


def read(s):
    got = [v for k, v in spans.fill(s).get("replay_spans_ms", {}).items()
           if k.startswith("vio.tria.")]
    bound = tria.run_bound_ms()
    if not got or not sum(got) or bound is None:
        return None
    return 100.0 * bound / sum(got)
