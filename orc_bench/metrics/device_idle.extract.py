"""device_idle.extract: the device's idle share of stage 05a's traced
window, 100% less the union of its kernel, copy and set intervals over
the window, in %: ``device_idle.demux``'s reader."""
from orc_bench.run import load_reader

read = load_reader("device_idle.demux")
