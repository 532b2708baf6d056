"""setup_s: from the process's first line to the window's start (host clock):
imports, the card, the inputs, registration with its fingerprints, the filter
builds, the kernels' loading (and on a checkout's first run their build), and
the traffic's warm rounds."""


def read(rec):
    return rec.setup_s
