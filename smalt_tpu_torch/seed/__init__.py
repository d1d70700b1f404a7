from .hitinfo import HitInfo, collect_hit_info, collect_hit_info_short
from .hitlist import HitList, collect_hits_using_cutoff, collect_hits_for_segment
