"""Native (C++) host code of the port: the exact 2-D/3-D hypervolume core
(hv.cpp), built by ``build.py`` and loaded by metrics/hypervolume.py."""
