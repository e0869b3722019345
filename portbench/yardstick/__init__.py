"""The yardstick: inputs from the seed, the plain reference, the
comparison that decides ``correct``, the roofline's counts and peaks, and
the reduction of a traced window. Nothing here imports the program."""
