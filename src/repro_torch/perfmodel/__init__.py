"""Hardware descriptors (``hardware.py``), the reference's performance
model as far as the port needs it: Alg 4's transfer distance."""
