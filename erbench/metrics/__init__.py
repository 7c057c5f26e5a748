"""One reader per metric, ``<metric>.py`` with ``read(reading)``, found
by the metric's name; ``spans`` holds what several readers share."""
