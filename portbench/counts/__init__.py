"""The yardstick's counts: the H100's published peaks and the work a step
of the problem needs, counted from the problem (the configuration's
fields, dtypes and physics, and the pairs inside the support), never
from a kernel's arguments."""
