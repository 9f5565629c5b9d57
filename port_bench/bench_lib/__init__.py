"""The benchmark's own code: loading cells by name, seeded inputs, timing,
trace reduction, the FLOP counter and the peaks.  Nothing here imports the
program; the drivers under ``drivers/`` do."""
