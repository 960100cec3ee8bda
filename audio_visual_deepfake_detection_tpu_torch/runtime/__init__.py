"""Native host helpers: C++ sources under ``csrc/`` built with g++ at first
use and bound through ctypes (``host_resample``, ``host_match``)."""
