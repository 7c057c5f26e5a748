"""One driver per traffic kind; a mix's ``kind`` names its module."""
