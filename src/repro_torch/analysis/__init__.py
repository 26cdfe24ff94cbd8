"""Static checks of the port's own code (port of ``repro/analysis``): so
far the host-sync check, ``hostsync``."""
