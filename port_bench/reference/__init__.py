"""Plain PyTorch references of the benchmark's configurations; nothing here
imports the program."""
