"""Shared constants: CIGAR operations, feature-map color scheme, thresholds.

The color scheme and detection thresholds reproduce the reference engine's
DeepVariant-style encoding (see /root/reference c++/src/AlleleSearcherLiteFiltered.cpp:361-397
for the constructor defaults) so that feature tensors are numerically
compatible with models trained on the reference pipeline.
"""

# BAM CIGAR operation codes (SAM spec)
BAM_CMATCH = 0
BAM_CINS = 1
BAM_CDEL = 2
BAM_CREF_SKIP = 3
BAM_CSOFT_CLIP = 4
BAM_CHARD_CLIP = 5
BAM_CPAD = 6
BAM_CEQUAL = 7
BAM_CDIFF = 8
BAM_CBACK = 9

CIGAR_OPS_STR = "MIDNSHP=XB"

# Feature-map channel indices (AlleleSearcherLiteFiltered.h track constants)
READ_BASE_TRACK = 0
REF_BASE_TRACK = 1
READ_QUAL_TRACK = 2
READ_MAPQ_TRACK = 3
READ_ORIENTATION_TRACK = 4
POSITION_MARKER_TRACK = 5
HP_TRACK = 6

# Color scheme (uint8 values)
BASE_COLOR_OFFSET_A_AND_G = 40
BASE_COLOR_OFFSET_T_AND_C = 30
BASE_COLOR_STRIDE = 70
BASE_QUALITY_CAP = 40
MAPPING_QUALITY_CAP = 60
POSITIVE_STRAND_COLOR = 70
NEGATIVE_STRAND_COLOR = 240
ALLELE_POSITION_COLOR = 240
BACKGROUND_POSITION_COLOR = 70

#: base -> color for READ/REF base tracks (gaps and N encode as 0)
BASE_COLORS = {
    "A": BASE_COLOR_OFFSET_A_AND_G + 3 * BASE_COLOR_STRIDE,  # 250
    "G": BASE_COLOR_OFFSET_A_AND_G + 2 * BASE_COLOR_STRIDE,  # 180
    "T": BASE_COLOR_OFFSET_T_AND_C + 1 * BASE_COLOR_STRIDE,  # 100
    "C": BASE_COLOR_OFFSET_T_AND_C + 0 * BASE_COLOR_STRIDE,  # 30
}

HP_COLORS = {0: 0, 1: 120, 2: 240}


def base_color(base: str) -> int:
    return BASE_COLORS.get(base, 0)


def base_quality_color(qual: int) -> int:
    capped = min(qual, BASE_QUALITY_CAP)
    return int(254 * (1.0 * capped / BASE_QUALITY_CAP))


def mapping_quality_color(qual: int) -> int:
    capped = min(qual, MAPPING_QUALITY_CAP)
    return int(254 * (1.0 * capped / MAPPING_QUALITY_CAP))


def strand_color(orientation: int) -> int:
    return POSITIVE_STRAND_COLOR if orientation > 0 else NEGATIVE_STRAND_COLOR


def hp_color(hp: int) -> int:
    return HP_COLORS.get(hp, 0)


# Candidate detection defaults (AlleleSearcherLiteFiltered ctor)
SNV_THRESHOLD = 0.12
INDEL_THRESHOLD = 0.12
MIN_COUNT = 2
MIN_MAPQ = 10
Q_THRESHOLD = 10
MAX_ALLELE_SIZE = 100
BAND_MARGIN = 6
MAX_REASSEMBLY_REGION_SIZE = 10
MIN_DEPTH_FOR_PACBIO_REALIGNMENT = 20

# Pipeline defaults
FEATURE_LENGTH = 150
MIN_DISTANCE = 30            # hotspot clustering radius (PileupDataTools.MIN_DISTANCE)
FLANKING_BASES = 75          # read-fetch flanks around active regions
MAX_ALLELE_LENGTH = 80       # maximum allele length used in candidate records
MAX_ITEMS_PER_GROUP_CALL = 1024   # cluster split cap in calling mode
MAX_ITEMS_PER_GROUP_TRAIN = 8     # cluster split cap in training mode
CHUNK_SIZE_ILLUMINA = 400
CHUNK_SIZE_PACBIO = 10000
MAX_NUM_READS_ILLUMINA = 10000
MAX_NUM_READS_PACBIO = 1000
READ_RATE_ILLUMINA = (1000, 30)
READ_RATE_PACBIO = (100, 100)
MAX_SEGMENT_SIZE_LABELING = 10
