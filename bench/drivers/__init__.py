"""One driver a traffic kind: ``bench.drivers.<kind>.Driver``."""
