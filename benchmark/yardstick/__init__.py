"""The benchmark's own yardstick: manifest, traffic generator, trace
reduction, roofline arithmetic, the correctness comparison and the
import guard.  Nothing here imports the program under test; run.py
hands the program to it."""
