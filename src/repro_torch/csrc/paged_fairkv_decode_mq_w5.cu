// paged_fairkv_decode_mq_w5: the multi-query kernel's instantiations for
// chunks of 5 queries per warp, a translation unit of its own so that the
// multi-query library's instantiations compile in parallel;
// paged_fairkv_decode_mq.cu picks the width and calls it.
#include "paged_decode.cuh"

PAGED_MQ_PART(5)
