"""The harness: finds a cell's files by name, sets up the program, drives
the window, reads the metrics and checks the outputs."""
