"""Load drivers, one a kind of traffic mix, found by the mix's ``kind``."""
