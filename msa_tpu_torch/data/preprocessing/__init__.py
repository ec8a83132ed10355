"""Offline dataset preprocessing (CMU-MOSI / MOSEI, UR_FUNNY) into the
pickles ``cli.train --data_pkl`` reads."""
