"""The benchmark's yardstick: frozen copies of the port's roofline
arithmetic and kernel classes, and the model FLOP counter of a
configuration's shapes. Nothing here imports the program."""
