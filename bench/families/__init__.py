"""The architecture families that configuration files name under
``family`` (:func:`bench.spec.family` loads each by its path)."""
