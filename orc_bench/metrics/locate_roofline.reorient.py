"""locate_roofline.reorient: the least time of the INFIX locate work that
the window's scans needed (every scan stage 01 dispatched: first pass,
autotune and enumeration rounds; each read's own length by the primers'
lengths, counted into ``locate_ops``/``locate_bytes``) over the device
time of the locate kernels, in %: ``locate_roofline.demux``'s reader."""
from orc_bench.run import load_reader

read = load_reader("locate_roofline.demux")
