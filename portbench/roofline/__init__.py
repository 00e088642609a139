"""The work of each kernel call, worked out from the configuration and
the prompt length, and the peaks it is held against.  Nothing here reads
the program's own counts, so a share reads the same work whatever
implements it."""
