"""Host time of one ``scan.graphed`` call in the stream cells' span slice
(``portbench/spans.py``): the program's ``graphed.call`` span, i.e. the
copy of the frame into the graph's inputs, the replay's launch and the
clones of its outputs; mean over the slice's frames, in ms."""
from portbench import spans


def read(s):
    return spans.fill(s).get("graphed_host_ms")
