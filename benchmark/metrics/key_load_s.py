"""Set-up's load of the SRS and the index keys from the archive in
benchmark/cache/ (`snark/serial.py::load_index_pk`), seconds."""


def read(rec: dict):
    return rec["setup"].get("key_load_s")
